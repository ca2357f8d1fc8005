"""Plain PyTorch reference of a Llama-shaped decoder, in float32.

It follows the published Llama/Mistral description (Hugging Face's
``LlamaForCausalLM``): RMSNorm before attention and before the gated MLP,
rotary embeddings on the two halves of each head (``rotate_half``, the
angles in float32 as ``position * inv_freq``), grouped-query attention
where query head ``h`` reads key/value head ``h // (heads / kv_heads)``,
a causal softmax over ``q k^T / sqrt(head_dim)``, ``silu(x W1^T) *
(x W3^T)`` then ``W2``, the final norm and the LM head.  No kernel, no
cache, no batching: every sequence runs through the whole model from its
first token.

It runs layer by layer over all the sequences it is given and makes each
layer's weights again from the seed (``model.block_weights`` over the
blocks of ``archs/llama.py``), so it holds one layer at a time.  It
imports nothing of the program.

``precision="f32"`` turns TF32 off.  ``precision="tf32"`` is the control,
the precision just below the configuration's: TF32 matrix products on a
CUDA card, and on the CPU, which has no TF32, every operand of every
product rounded to TF32's 10-bit mantissa.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Sequence

import torch

from portbench.archs import llama
from portbench.model import block_weights


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest TF32 value (10 mantissa bits)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


@contextlib.contextmanager
def matmul_precision(precision: str, device: torch.device):
    if precision not in ("f32", "tf32"):
        raise ValueError(f"precision must be 'f32' or 'tf32': {precision!r}")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    tf32 = precision == "tf32" and device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _matmul(precision: str, device: torch.device) -> Callable:
    if precision == "tf32" and device.type != "cuda":
        return lambda a, b: torch.matmul(_round_tf32(a), _round_tf32(b))
    return torch.matmul


def _rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x, cos, sin):
    """``x``: [T, heads, head_dim]; cos, sin: [T, head_dim / 2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def _rope_tables(s: llama.Shapes, n: int, device):
    half = s.head_dim // 2
    inv = 1.0 / (s.rope_theta ** (torch.arange(half, dtype=torch.float32,
                                               device=device) / half))
    ang = torch.arange(n, dtype=torch.float32, device=device)[:, None] \
        * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def _layer(s: llama.Shapes, i: int, w: Dict[str, torch.Tensor], h, cos,
           sin, mm):
    T = h.shape[0]
    dh, H, Hkv = s.head_dim, s.heads, s.kv_heads
    x = _rms_norm(h, w[f"Attention_Norm_L{i}"], s.eps)
    q = mm(x, w[f"Q_weights_L{i}"].reshape(H * dh, s.d).T).view(T, H, dh)
    k = mm(x, w[f"K_weights_L{i}"].reshape(Hkv * dh, s.d).T).view(T, Hkv, dh)
    v = mm(x, w[f"V_weights_L{i}"].reshape(Hkv * dh, s.d).T).view(T, Hkv, dh)
    q, k = _rope(q, cos[:T], sin[:T]), _rope(k, cos[:T], sin[:T])
    g = H // Hkv
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    scores = mm(q.transpose(0, 1), k.permute(1, 2, 0)) / dh ** 0.5
    mask = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    att = mm(torch.softmax(scores, dim=-1), v.transpose(0, 1))
    h = h + mm(att.transpose(0, 1).reshape(T, H * dh), w[f"o_weights_L{i}"].T)
    x = _rms_norm(h, w[f"FFN_Norm_L{i}"], s.eps)
    gate = torch.nn.functional.silu(mm(x, w[f"GLU_W1_L{i}"].T))
    up = mm(x, w[f"GLU_W3_L{i}"].T)
    return h + mm(gate * up, w[f"GLU_W2_L{i}"].T)


@torch.no_grad()
def logits(s: llama.Shapes, seed: int, seqs: Sequence[Sequence[int]],
           first: Sequence[int], device, precision: str = "f32"
           ) -> List[torch.Tensor]:
    """For each token sequence, the logits at its positions ``first[j]``
    onward: a ``[len - first, vocab]`` float32 tensor on ``device``.  The
    logits at position ``p`` predict token ``p + 1``."""
    device = torch.device(device)
    mm = _matmul(precision, device)
    with matmul_precision(precision, device):
        emb = block_weights(llama, s, seed, "embed", device)["vocabulary"]
        hs = [emb[torch.as_tensor(list(q), device=device)] for q in seqs]
        del emb
        cos, sin = _rope_tables(s, max(len(q) for q in seqs), device)
        for i in range(s.layers):
            w = block_weights(llama, s, seed, f"layer{i}", device)
            hs = [_layer(s, i, w, h, cos, sin, mm) for h in hs]
            del w
        w = block_weights(llama, s, seed, "head", device)
        return [mm(_rms_norm(h[f:], w["Final_Norm"], s.eps), w["lm_head"].T)
                for h, f in zip(hs, first)]
