"""The least time of the window's projection work (the architecture's
``decode_least_s`` and ``prefill_least_s``: for a Llama, each projection
of each layer and the LM head at the rows the work needs) over the
device time of K1's kernels (``kernels/csrc/chunked_matmul.cu``, matched
by name in the trace)."""

import re

K1 = re.compile(r"\b(gemv_kernel|gemv_col_kernel|gemm_kernel|"
                r"splitk_reduce_kernel)\b")


def read(w):
    if w.device is None:
        return None
    k1_s = sum(s for name, s in w.device["by_name"].items()
               if K1.search(name))
    least = (sum(w.arch.decode_least_s(w.shapes, rows, w.peaks)
                 for _, _, rows, _ in w.decodes)
             + sum(w.arch.prefill_least_s(w.shapes, ctx, cached, w.peaks)
                   for _, _, ctx, cached in w.prefills))
    if not k1_s or not least:
        return None
    return 100.0 * least / k1_s
