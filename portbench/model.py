"""A configuration's shapes, and its weights made from the seed.

The weights are drawn block by block on the device: the embedding, each
decoder layer, and the final norm with the LM head.  Each block comes
from one ``randn`` call of a generator seeded from ``(seed, block)``, so
the reference can make one layer again without holding the model, and
the program and the reference are handed the same numbers.  Tensor
names and layouts are the Llama graph's (``Q_weights_L{i}`` is
``[heads, head_dim, d_model]``, every matrix is ``[out, in]``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, Iterator, List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Shapes:
    """The sizes of a Llama-shaped decoder, from a ``config.json``."""

    vocab: int
    d: int
    layers: int
    heads: int
    kv_heads: int
    ff: int
    rope_theta: float
    eps: float
    head_dim: int

    @classmethod
    def from_config(cls, cfg: Dict) -> "Shapes":
        d, h = cfg["hidden_size"], cfg["num_attention_heads"]
        return cls(vocab=cfg["vocab_size"], d=d,
                   layers=cfg["num_hidden_layers"], heads=h,
                   kv_heads=cfg.get("num_key_value_heads", h),
                   ff=cfg["intermediate_size"],
                   rope_theta=float(cfg["rope_theta"]),
                   eps=float(cfg["rms_norm_eps"]),
                   head_dim=cfg.get("head_dim") or d // h)

    def layer_matrices(self) -> List[Tuple[str, int, int]]:
        """``(name, out, in)`` of a layer's seven projections."""
        d, dh = self.d, self.head_dim
        return [("Q_weights", self.heads * dh, d),
                ("K_weights", self.kv_heads * dh, d),
                ("V_weights", self.kv_heads * dh, d),
                ("o_weights", d, self.heads * dh),
                ("GLU_W1", self.ff, d),
                ("GLU_W3", self.ff, d),
                ("GLU_W2", d, self.ff)]


def block_names(s: Shapes) -> List[str]:
    return ["embed"] + [f"layer{i}" for i in range(s.layers)] + ["head"]


def _block_spec(s: Shapes, block: str
                ) -> List[Tuple[str, Tuple[int, ...], Optional[float]]]:
    """``(tensor, shape, scale)``; a scale of ``None`` is a norm weight,
    drawn as ``1 + 0.1 * randn``."""
    d, dh = s.d, s.head_dim
    if block == "embed":
        return [("vocabulary", (s.vocab, d), 0.02)]
    if block == "head":
        return [("Final_Norm", (d,), None),
                ("lm_head", (s.vocab, d), 1 / math.sqrt(d))]
    i = int(block[len("layer"):])
    return [(f"Attention_Norm_L{i}", (d,), None),
            (f"Q_weights_L{i}", (s.heads, dh, d), 1 / math.sqrt(d)),
            (f"K_weights_L{i}", (s.kv_heads, dh, d), 1 / math.sqrt(d)),
            (f"V_weights_L{i}", (s.kv_heads, dh, d), 1 / math.sqrt(d)),
            (f"o_weights_L{i}", (d, s.heads * dh), 1 / math.sqrt(s.heads * dh)),
            (f"FFN_Norm_L{i}", (d,), None),
            (f"GLU_W1_L{i}", (s.ff, d), 1 / math.sqrt(d)),
            (f"GLU_W3_L{i}", (s.ff, d), 1 / math.sqrt(d)),
            (f"GLU_W2_L{i}", (d, s.ff), 1 / math.sqrt(s.ff))]


def block_seed(seed: int, block: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}:{block}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def block_weights(s: Shapes, seed: int, block: str, device
                  ) -> Dict[str, torch.Tensor]:
    """One block's tensors, views of one f32 buffer drawn on ``device``."""
    spec = _block_spec(s, block)
    total = sum(math.prod(shape) for _, shape, _ in spec)
    gen = torch.Generator(device=device).manual_seed(block_seed(seed, block))
    buf = torch.randn(total, generator=gen, device=device,
                      dtype=torch.float32)
    out, off = {}, 0
    for name, shape, scale in spec:
        n = math.prod(shape)
        t = buf[off:off + n].view(shape)
        off += n
        if scale is None:
            t.mul_(0.1).add_(1.0)
        else:
            t.mul_(scale)
        out[name] = t
    return out


class SeededWeights:
    """The whole model's weights as the engine takes them (``items()``),
    drawn one block at a time as they are iterated: an engine that copies
    each tensor into its own store (paged residency) never holds more
    than one block of them on the device."""

    def __init__(self, s: Shapes, seed: int, device):
        self.shapes, self.seed, self.device = s, seed, device

    def items(self) -> Iterator[Tuple[str, torch.Tensor]]:
        for block in block_names(self.shapes):
            yield from block_weights(self.shapes, self.seed, block,
                                     self.device).items()
