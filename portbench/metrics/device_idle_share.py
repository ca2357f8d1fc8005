"""Share of the traced window in which no kernel, copy or set ran on the
card."""


def read(w):
    if w.device is None or not w.device["window_s"]:
        return None
    return 100.0 * (1 - w.device["busy_s"] / w.device["window_s"])
