"""Share of the traced window in which the card is idle while the
scheduler thread, inside a prefill or decode call, dispatches the
model's steps: its innermost open span a ``step`` or ``op`` span
(``idlespans``; a collection overrides it).  Reads the window's named
idle pieces, which only a run with the program's tracer has."""

from portbench import idlespans


def read(w):
    return idlespans.share(getattr(w, "idle_named", None), "dispatch",
                           (w.device or {}).get("window_s"))
