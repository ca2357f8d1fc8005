"""Mixture-of-experts FFN with sort-based token dispatch.

Top-k routing uses a capacity-bounded, sort-based dispatch: (token, k) pairs
are sorted by expert id, scattered into per-expert buffers [E, C, D], run
through batched expert FFNs, and combined back with the router gates.

The dispatch order is the reference's: top-k breaks ties toward the lower
expert index (``jax.lax.top_k``), and the sort by expert id is stable
(``jnp.argsort``), so a capacity drop keeps the same (token, k) pairs.

Relational reading: the expert id is one more chunk-table key; routing =
ORDER BY gate DESC LIMIT k per token row; dispatch = the equi-join of the
token table against the expert weight tables.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import DTYPES, dense_init, mlp_apply, normal


def moe_init(gen, cfg: ModelConfig, *, device) -> Dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def experts(i, o):  # E fan-in weights [i, o], drawn at once
        return (normal(gen, (E, i, o), device=device) * i ** -0.5).to(
            DTYPES[cfg.param_dtype])

    p = {
        "router": dense_init(gen, d, E, cfg, scale=0.02, device=device),
        "w1": experts(d, f),
        "w3": experts(d, f),
        "w2": experts(f, d),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {"w1": dense_init(gen, d, fs, cfg, device=device),
                       "w3": dense_init(gen, d, fs, cfg, device=device),
                       "w2": dense_init(gen, fs, d, cfg, device=device)}
    return p


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)  # round up to 8, as the reference tiles


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last dim, ties toward the
    lower index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    B, T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    N = B * T
    xf = x.reshape(N, D)

    logits = (xf @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k(probs, K)  # [N, K]
    if cfg.router_normalize:
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    gates = gates.to(x.dtype)

    # ---- sort-based dispatch ------------------------------------------------
    flat_e = idx.reshape(-1)                                   # [N*K]
    flat_t = torch.arange(N, device=x.device).repeat_interleave(K)
    flat_g = gates.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]

    counts = torch.bincount(flat_e, minlength=E)               # per expert
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(N * K, device=x.device) - starts[se]    # slot
    C = capacity(N, cfg)
    keep = pos < C
    pos_c = torch.where(keep, pos, 0)

    buf = torch.zeros((E, C, D), dtype=x.dtype, device=x.device)
    buf.index_put_((se, pos_c),
                   torch.where(keep[:, None], xf[st], 0).to(x.dtype),
                   accumulate=True)

    # ---- batched expert FFN (SwiGLU) ---------------------------------------
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, p["w1"]))
    h = h * torch.einsum("ecd,edf->ecf", buf, p["w3"])
    out_buf = torch.einsum("ecf,efd->ecd", h, p["w2"])

    # ---- combine -------------------------------------------------------------
    y = torch.zeros((N, D), dtype=x.dtype, device=x.device)
    contrib = out_buf[se, pos_c] * (sg * keep.to(sg.dtype))[:, None]
    y.index_add_(0, st, contrib)

    if "shared" in p:
        y = y + mlp_apply(p["shared"], xf, cfg)
    return y.reshape(B, T, D)


def moe_apply_ep_local(p: Dict, x: torch.Tensor, cfg: ModelConfig
                       ) -> torch.Tensor:
    """Expert-parallel MoE with local dispatch.

    The reference runs each model shard's own experts inside ``shard_map``
    and combines with one ``psum`` when a device mesh with a ``model`` axis
    is current, and falls back to :func:`moe_apply` otherwise.  The port has
    no mesh yet (it comes with the distributed slice), so it always takes
    that fallback: the same function, the same outputs.
    """
    return moe_apply(p, x, cfg)


def aux_load_balance_loss(p: Dict, x: torch.Tensor, cfg: ModelConfig
                          ) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (training only)."""
    B, T, D = x.shape
    xf = x.reshape(B * T, D)
    probs = torch.softmax((xf @ p["router"]).float(), -1)
    _, idx = top_k(probs, cfg.top_k)
    onehot = F.one_hot(idx[:, 0], cfg.n_experts).float()
    frac_tokens = onehot.mean(0)
    frac_probs = probs.mean(0)
    return cfg.n_experts * torch.sum(frac_tokens * frac_probs)
