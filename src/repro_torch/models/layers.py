"""Shared building blocks: norms, rotary embedding, MLPs, embeddings.

Every block follows the reference's (init, apply) convention with plain-dict
parameter trees: ``*_init`` draws from an explicit ``torch.Generator`` on
``device`` (the ``meta`` device gives shapes and dtypes only), ``*_apply``
is a plain function of tensors that runs where its inputs are.  The
reference's ``shard(...)`` constraints are in place: no-ops without a
device mesh, ``redistribute``s of DTensor activations under one
(``repro_torch.distributed.sharding``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import shard

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.param_dtype]


def normal(gen: torch.Generator, shape, *, device) -> torch.Tensor:
    """Standard normal f32 draw of ``shape`` from ``gen`` on ``device``."""
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                       device=device)


def dense_init(gen, in_dim: int, out_shape, cfg: ModelConfig, scale=None, *,
               device) -> torch.Tensor:
    """Weight [in_dim, *out_shape] with fan-in init."""
    out_shape = (out_shape,) if isinstance(out_shape, int) else tuple(out_shape)
    scale = scale if scale is not None else in_dim ** -0.5
    w = normal(gen, (in_dim,) + out_shape, device=device)
    return (w * scale).to(_dtype(cfg))


# -- norms ---------------------------------------------------------------------


def norm_init(cfg: ModelConfig, d: Optional[int] = None, *, device) -> Dict:
    d = d or cfg.d_model
    if not cfg.parametric_norm:
        return {}
    p = {"scale": torch.ones(d, dtype=_dtype(cfg), device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(d, dtype=_dtype(cfg), device=device)
    return p


def norm_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.eps)
    else:  # rmsnorm
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + cfg.eps)
    if p:
        y = y * p["scale"].float()
        if "bias" in p:
            y = y + p["bias"].float()
    return y.to(x.dtype)


def vec_norm_apply(scale: Optional[torch.Tensor], x: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """RMS-normalise the trailing dim (qk-norm / MLA latent norm)."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    if scale is not None:
        y = y * scale.float()
    return y.to(x.dtype)


# -- rotary position embedding ---------------------------------------------------


def rope_table(positions: torch.Tensor, head_dim: int, theta: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [*, head_dim/2] for given (integer) positions."""
    half = head_dim // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=positions.device) / half))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def rope_apply(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Half-split rotary: x [..., T, H, dh], cos/sin [..., T, half]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def sinusoidal_positions(n: int, d: int, *, device) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings [n, d]."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# -- MLPs ------------------------------------------------------------------------


def mlp_init(gen, cfg: ModelConfig, d_ff: Optional[int] = None, *,
             device) -> Dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "silu":  # SwiGLU
        return {"w1": dense_init(gen, d, f, cfg, device=device),
                "w3": dense_init(gen, d, f, cfg, device=device),
                "w2": dense_init(gen, f, d, cfg, device=device)}
    return {"w1": dense_init(gen, d, f, cfg, device=device),
            "w2": dense_init(gen, f, d, cfg, device=device)}


def mlp_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.act == "silu":
        h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    else:
        h = F.gelu(x @ p["w1"], approximate="tanh")
    h = shard(h, "batch", None, "mlp")
    return h @ p["w2"]


# -- embeddings -------------------------------------------------------------------


def embed_init(gen, cfg: ModelConfig, *, device) -> Dict:
    e = normal(gen, (cfg.vocab, cfg.d_model), device=device) * 0.02
    return {"embedding": e.to(_dtype(cfg))}


def embed_apply(p: Dict, ids: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Rows of the embedding table; an id outside ``[0, vocab)`` raises
    (the reference's ``jnp.take`` fills its row with NaN)."""
    return F.embedding(ids, p["embedding"])


def unembed_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return x @ p["embedding"].T.to(x.dtype)
