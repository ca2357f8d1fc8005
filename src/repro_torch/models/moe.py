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
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import psum
from repro_torch.distributed.sharding import (P, axis_size, current_mesh,
                                              logical_spec, mesh_shape,
                                              placements, shard)
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


def _replicated(t: torch.Tensor) -> torch.Tensor:
    """A DTensor replicated on every mesh dim; a plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(ids, minlength=n)`` for ids in ``[0, n)``, with a
    shape that does not depend on the data (a dry-run counts it on fake
    tensors)."""
    return torch.zeros(n, dtype=torch.long, device=ids.device).index_add(
        0, ids, torch.ones_like(ids))


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
    # one global sort over every token, as the reference's: on a mesh the
    # routing and the tokens are replicated first (all-gathers), so each
    # index op below runs on whole tensors on every rank
    flat_e = _replicated(idx.reshape(-1))                      # [N*K]
    flat_t = torch.arange(N, device=x.device).repeat_interleave(K)
    flat_g = _replicated(gates.reshape(-1))
    xf_all = _replicated(xf)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]

    counts = _counts(flat_e, E)                                # per expert
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(N * K, device=x.device) - starts[se]    # slot
    C = capacity(N, cfg)
    keep = pos < C
    pos_c = torch.where(keep, pos, 0)

    buf = torch.zeros((E, C, D), dtype=x.dtype, device=x.device)
    rows = torch.where(keep[:, None], xf_all[st], 0).to(x.dtype)
    buf = buf.index_put((se, pos_c), rows, accumulate=True)
    buf = shard(buf, "expert", None, None)

    # ---- batched expert FFN (SwiGLU) ---------------------------------------
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, p["w1"]))
    h = h * torch.einsum("ecd,edf->ecf", buf, p["w3"])
    h = shard(h, "expert", None, None)
    out_buf = torch.einsum("ecf,efd->ecd", h, p["w2"])

    # ---- combine (the expert buffer gathered whole on a mesh) ---------------
    out_buf = _replicated(out_buf)
    contrib = out_buf[se, pos_c] * (sg * keep.to(sg.dtype))[:, None]
    y = torch.zeros((N, D), dtype=x.dtype, device=x.device).index_add(
        0, st, contrib)

    if "shared" in p:
        y = y + mlp_apply(p["shared"], xf, cfg)
    return y.reshape(B, T, D)


def moe_apply_ep_local(p: Dict, x: torch.Tensor, cfg: ModelConfig
                       ) -> torch.Tensor:
    """Expert-parallel MoE with *local* dispatch.

    Under TP, activations are replicated across the model axis while the
    expert stack is sharded over it.  Every model shard already *has* all
    tokens, so it filters the (token, k) pairs routed to its own
    ``E / n_model`` experts, runs its expert slice, and contributes its
    partial output to one sum over ``model`` — the same wire cost as a TP
    MLP all-reduce, instead of gathering the full expert buffer.

    The reference's ``shard_map``, here on the current ``DeviceMesh``: x
    goes to its batch shards, the router whole and each expert stack to
    ``model`` shards (``redistribute`` → ``to_local``; a plain tensor is
    taken as replicated), the body runs on each rank's blocks, and y comes
    back as a DTensor sharded as the batch.  The sum over ``model`` is
    differentiable (:func:`collectives.psum`), and each input's gradient is
    summed over the mesh axes it was replicated on.  Falls back to
    :func:`moe_apply` without a mesh, without a ``model`` axis of more than
    one rank, or when the experts do not split over it.
    """
    mesh = current_mesh()
    shape = mesh_shape(mesh) if mesh is not None else {}
    if shape.get("model", 1) == 1 or cfg.n_experts % shape["model"] != 0:
        return moe_apply(p, x, cfg)

    n_shards = shape["model"]
    E_loc = cfg.n_experts // n_shards
    B, T, D = x.shape
    N = B * T
    K = cfg.top_k
    batch_spec = logical_spec("batch")
    bax = batch_spec[0] if len(batch_spec) else None
    C = capacity(max(1, N // axis_size(mesh, bax)), cfg)  # per-shard tokens

    def local(t, spec):
        """This rank's block of ``t`` under ``spec``; its gradient summed
        over the mesh axes the block is replicated on."""
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        pl = placements(spec, mesh)
        return t.redistribute(mesh, pl).to_local(
            grad_placements=[q if q.is_shard() else Partial() for q in pl])

    xl = local(x, P(bax, None, None))
    router = local(p["router"], P(None, None))
    w1, w3, w2 = (local(p[k], P("model", None, None))
                  for k in ("w1", "w3", "w2"))

    me = mesh.get_local_rank("model")
    Bl, Tl, _ = xl.shape
    Nl = Bl * Tl
    xf = xl.reshape(Nl, D)
    logits = (xf @ router).float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k(probs, K)
    if cfg.router_normalize:
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    gates = gates.to(xl.dtype)

    flat_e = idx.reshape(-1)
    flat_t = torch.arange(Nl, device=xl.device).repeat_interleave(K)
    flat_g = gates.reshape(-1)
    mine = (flat_e // E_loc) == me          # my experts only
    local_e = torch.where(mine, flat_e % E_loc, E_loc)  # E_loc = drop row
    order = torch.argsort(local_e, stable=True)
    se, st, sg = local_e[order], flat_t[order], flat_g[order]
    counts = _counts(local_e, E_loc + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(Nl * K, device=xl.device) - starts[
        torch.clamp(se, max=E_loc)]
    keep = (se < E_loc) & (pos < C)
    pos_c = torch.where(keep, pos, 0)
    se_c = torch.where(keep, se, 0)

    buf = torch.zeros((E_loc, C, D), dtype=xl.dtype, device=xl.device)
    buf = buf.index_put((se_c, pos_c),
                        torch.where(keep[:, None], xf[st], 0).to(xl.dtype),
                        accumulate=True)
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, w1))
    h = h * torch.einsum("ecd,edf->ecf", buf, w3)
    out_buf = torch.einsum("ecf,efd->ecd", h, w2)

    contrib = out_buf[se_c, pos_c] * (sg * keep.to(sg.dtype))[:, None]
    y = torch.zeros((Nl, D), dtype=xl.dtype, device=xl.device).index_add(
        0, st, contrib)
    # combine across expert shards: one TP-style all-reduce
    y = psum(y, mesh, "model").reshape(Bl, Tl, D)
    y = DTensor.from_local(y, mesh, placements(P(bax, None, None), mesh),
                           run_check=False, shape=(B, T, D),
                           stride=(T * D, D, 1))
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x.reshape(N, D), cfg).reshape(B, T, D)
    return y


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
