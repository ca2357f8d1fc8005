"""From the start of the process to the first request of the load:
imports, weights from the seed, the engine's tables and plans, the
kernels' build where the checkout has none, and the warm-up."""


def read(w):
    return w.setup_s
