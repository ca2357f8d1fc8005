"""Every token delivered inside the window, over the window's length
(client clock)."""


def read(w):
    n = sum(1 for r in w.requests for t in r["times"] if w.in_window(t))
    return n / w.seconds if n else None
