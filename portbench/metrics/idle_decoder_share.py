"""Share of the traced window in which the card is idle while the
scheduler thread, inside a prefill or decode call, is in the decoder's
own phases (session set-up, the cache gathers and writes,
``device_wait`` on the logits): its innermost open span a ``decoder``
span (``idlespans``; a collection overrides it).  Reads the window's
named idle pieces, which only a run with the program's tracer has."""

from portbench import idlespans


def read(w):
    return idlespans.share(getattr(w, "idle_named", None), "decoder",
                           (w.device or {}).get("window_s"))
