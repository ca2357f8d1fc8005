"""Live sequences a decode tick advanced, on average over the window:
the rows of the window's decode calls over the change in
``BatchedDecoder.decode_calls``."""


def read(w):
    ticks = w.delta("decode_calls")
    if not ticks:
        return None
    return sum(rows for _, _, rows, _ in w.decodes) / ticks
