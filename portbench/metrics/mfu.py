"""Model FLOPs of the work served in the window (the architecture's
``decode_flops`` and ``prefill_flops``: for a Llama, uncached prefill
tokens and decode tokens, the LM head, attention over the keys each
token reads) over the window's length times the card's float32 peak."""


def read(w):
    flops = (sum(w.arch.decode_flops(w.shapes, rows, keys)
                 for _, _, rows, keys in w.decodes)
             + sum(w.arch.prefill_flops(w.shapes, ctx, cached)
                   for _, _, ctx, cached in w.prefills))
    if not flops or not w.gate_s:
        return None
    return 100.0 * flops / (w.gate_s * w.peaks["f32_flops_per_s"])
