"""Median, over the requests sent inside the window, of the time from
sending to the first token's chunk (client clock).  A request that got
no first token counts as the slowest."""

from portbench.window import quantile


def read(w):
    sent = w.sent_in_window()
    if not sent:
        return None
    ttft = [(r["times"][0] - r["sent"]) * 1e3 if r["times"]
            else float("inf") for r in sent]
    v = quantile(sorted(ttft), 50)
    return v if v != float("inf") else None
