"""Attention blocks: GQA/MQA (+qk-norm, sliding window), cross-attention,
and DeepSeek-style MLA (multi-head latent attention) with compressed cache.

A single code path serves training (no cache), prefill (cache write) and
decode (cache append + single query): the query block always attends over a
KV block whose positions are explicit, and masking is computed from
positions.

The attention is the reference's ``_sdpa`` written out (einsum, f32 scores
plus an additive ``-1e30`` mask, softmax, einsum): the dense baseline stays
the reference's function.  A cache write goes into the cache tensors in
place; a write past the cache's end raises ``IndexError`` where the
reference's ``dynamic_update_slice`` clamps the start so the update fits.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import shard
from repro_torch.models.layers import (DTYPES, dense_init, rope_apply,
                                       rope_table, vec_norm_apply)

NEG_INF = -1e30


# -- masking -------------------------------------------------------------------


def make_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
              window=0, kv_valid=None) -> torch.Tensor:
    """Additive mask [Tq, Skv] from explicit positions.  ``window`` is an
    int or a 0-d tensor (a per-layer schedule entry); 0 disables it."""
    q = q_pos[:, None]
    s = kv_pos[None, :]
    ok = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= s <= q
    window = int(window)
    if window > 0:
        ok &= s > q - window
    if kv_valid is not None:
        ok &= s < kv_valid
    return torch.where(ok, 0.0, NEG_INF).float()


def _write(buf: torch.Tensor, new: torch.Tensor, start: int) -> None:
    """``buf[:, start:start + T] = new`` in place, inside the cache."""
    T = new.shape[1]
    if not 0 <= start <= buf.shape[1] - T:
        raise IndexError(f"cache write of {T} rows at {start} past a cache "
                         f"of {buf.shape[1]} rows")
    buf[:, start:start + T] = new.to(buf.dtype)


# -- grouped-query attention -----------------------------------------------------


def attn_init(gen, cfg: ModelConfig, cross: bool = False,
              n_heads: Optional[int] = None, n_kv: Optional[int] = None, *,
              device) -> Dict:
    d, dh = cfg.d_model, cfg.head_dim
    H = n_heads or cfg.n_heads
    Hkv = n_kv or cfg.n_kv
    p = {
        "wq": dense_init(gen, d, (H, dh), cfg, device=device),
        "wk": dense_init(gen, d, (Hkv, dh), cfg, device=device),
        "wv": dense_init(gen, d, (Hkv, dh), cfg, device=device),
        "wo": dense_init(gen, H * dh, d, cfg, device=device).reshape(H, dh, d),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(dh, dtype=p["wq"].dtype, device=device)
        p["k_norm"] = torch.ones(dh, dtype=p["wq"].dtype, device=device)
    if cross:  # llama-vision tanh gate
        p["gate"] = torch.zeros((), dtype=p["wq"].dtype, device=device)
    return p


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor, n_kv: int) -> torch.Tensor:
    """Grouped scaled-dot-product attention.

    q [B,T,H,dh], k/v [B,S,Hkv,dh], mask [T,S] additive (f32).

    On DTensors it runs per shard, as ``shard_map`` would: attention is
    independent across the batch and across KV-head groups, so q, k and v
    keep their batch shards, and their head shards on the mesh dims that
    shard both the query and the KV heads, and go replicated on every other
    mesh dim; each rank attends over its local block
    (``to_local`` → this function → ``DTensor.from_local``).  DTensor's own
    ``bmm`` strategy would see the batch and head shards flattened into one
    strided batch dim, whose redistribution planning grows with the mesh.
    K and V replicated on a mesh dim that shards the query's batch or heads
    (a cache placed by batch only, or gathered) are sliced the same way
    there, a local split with no communication, when their dim divides by
    it.
    """
    if isinstance(q, DTensor):
        mesh = q.device_mesh

        def kept(i, p):
            kp = k.placements[i]
            return any(p.is_shard(d) and (kp.is_shard(d) or (
                kp.is_replicate() and k.shape[d] % mesh.size(i) == 0))
                for d in (0, 2))
        pl = tuple(p if kept(i, p) else Replicate()
                   for i, p in enumerate(q.placements))
        ql, kl, vl = (t.redistribute(mesh, pl).to_local() for t in (q, k, v))
        out = _sdpa(ql, kl, vl, mask, kl.shape[2])
        return DTensor.from_local(out, mesh, pl, run_check=False,
                                  shape=q.shape, stride=q.stride())
    B, T, H, dh = q.shape
    g = H // n_kv
    qg = q.reshape(B, T, n_kv, g, dh)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k) / torch.tensor(
        dh, dtype=q.dtype).sqrt()
    scores = scores.float() + mask
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", p, v)
    return out.reshape(B, T, H, dh)


def attn_apply(
    p: Dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    q_pos: torch.Tensor,
    kv_x: Optional[torch.Tensor] = None,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_pos: Optional[int] = None,
    kv_valid=None,
    causal: bool = True,
    window=0,
    rope_cs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    kv_rope_cs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    meta_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (output, cache).

    cache: {"k","v"} [B, S_max, Hkv, dh]; the new K/V are written into it
    at ``cache_pos`` in place, and the same dict is returned.
    kv_x: source for K/V (cross-attention).
    """
    B, T, _ = x.shape
    Hkv = p["wk"].shape[1]
    q = torch.einsum("btd,dhk->bthk", x, p["wq"])
    q = shard(q, "batch", None, "heads", None)
    if cfg.qk_norm:
        q = vec_norm_apply(p.get("q_norm"), q, cfg.eps)

    kv_src = x if kv_x is None else kv_x
    k = torch.einsum("btd,dhk->bthk", kv_src, p["wk"])
    v = torch.einsum("btd,dhk->bthk", kv_src, p["wv"])
    k = shard(k, "batch", None, "kv_heads", None)
    v = shard(v, "batch", None, "kv_heads", None)
    if cfg.qk_norm:
        k = vec_norm_apply(p.get("k_norm"), k, cfg.eps)

    if rope_cs is not None:
        q = rope_apply(q, *rope_cs)
        k = rope_apply(k, *(kv_rope_cs or rope_cs))

    if cache is not None:
        start = int(cache_pos) if cache_pos is not None else 0
        _write(cache["k"], k, start)
        _write(cache["v"], v, start)
        k, v = cache["k"], cache["v"]
        kv_pos = torch.arange(k.shape[1], device=x.device)
    else:
        kv_pos = q_pos if kv_x is None else torch.arange(k.shape[1],
                                                         device=x.device)

    if meta_kv is not None:  # hymba meta tokens prepended to the KV block
        mk, mv = meta_kv
        k = torch.cat([mk.expand((B,) + mk.shape[-3:]), k], 1)
        v = torch.cat([mv.expand((B,) + mv.shape[-3:]), v], 1)
        n_meta = mk.shape[-3]
        kv_pos = torch.cat([torch.full((n_meta,), -1, dtype=kv_pos.dtype,
                                       device=kv_pos.device), kv_pos])

    mask = make_mask(q_pos, kv_pos, causal=causal and kv_x is None,
                     window=window, kv_valid=kv_valid)
    if meta_kv is not None:  # meta tokens always visible
        mask[:, : meta_kv[0].shape[-3]] = 0.0

    out = _sdpa(q, k, v, mask, Hkv)
    y = _out_proj(out, p["wo"])
    if "gate" in p:
        y = torch.tanh(p["gate"]) * y
    return y, cache


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bthd,hdD->btD")``.  On DTensors it runs per shard, for
    the reason :func:`_sdpa` gives: each rank contracts its block of heads
    with the same rows of ``wo``, and the sum over head shards stays
    pending (``Partial``) until the residual stream's ``shard`` reduces
    it; ``wo``'s gradient is summed over the batch shards."""
    if not isinstance(out, DTensor):
        return torch.einsum("bthd,hdD->btD", out, wo)
    mesh, pl = out.device_mesh, out.placements
    w_pl = [Shard(0) if p.is_shard(2) else Replicate() for p in pl]
    w_grad = [Partial() if p.is_shard(0) else w for p, w in zip(pl, w_pl)]
    wl = wo.redistribute(mesh, w_pl).to_local(grad_placements=w_grad)
    y = torch.einsum("bthd,hdD->btD", out.to_local(), wl)
    B, T, D = out.shape[0], out.shape[1], wo.shape[-1]
    return DTensor.from_local(y, mesh, [Partial() if p.is_shard(2) else p
                                        for p in pl],
                              run_check=False, shape=(B, T, D),
                              stride=(T * D, D, 1))


# -- multi-head latent attention (DeepSeek-V3) ------------------------------------


def mla_init(gen, cfg: ModelConfig, *, device) -> Dict:
    d = cfg.d_model
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dq = cfg.nope_head_dim + cfg.rope_head_dim
    H = cfg.n_heads
    pdt = DTYPES[cfg.param_dtype]
    return {
        "wq_a": dense_init(gen, d, qr, cfg, device=device),
        "q_norm": torch.ones(qr, dtype=pdt, device=device),
        "wq_b": dense_init(gen, qr, (H, dq), cfg, device=device),
        "wkv_a": dense_init(gen, d, kvr + cfg.rope_head_dim, cfg,
                            device=device),
        "kv_norm": torch.ones(kvr, dtype=pdt, device=device),
        "wkv_b": dense_init(gen, kvr, (H, cfg.nope_head_dim + cfg.v_head_dim),
                            cfg, device=device),
        "wo": dense_init(gen, H * cfg.v_head_dim, d, cfg,
                         device=device).reshape(H, cfg.v_head_dim, d),
    }


def mla_apply(
    p: Dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    q_pos: torch.Tensor,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_pos: Optional[int] = None,
    kv_valid=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """MLA with the *compressed* KV cache: the cache stores the rank-
    ``kv_lora_rank`` latent c_kv plus the shared rotary key, written in
    place at ``cache_pos``."""
    dn, dr = cfg.nope_head_dim, cfg.rope_head_dim

    q = torch.einsum("btd,dr->btr", x, p["wq_a"])
    q = vec_norm_apply(p["q_norm"], q, cfg.eps)
    q = torch.einsum("btr,rhk->bthk", q, p["wq_b"])
    q = shard(q, "batch", None, "heads", None)
    q_nope, q_pe = q[..., :dn], q[..., dn:]

    kv = torch.einsum("btd,dr->btr", x, p["wkv_a"])
    c_kv, k_pe = kv[..., : cfg.kv_lora_rank], kv[..., cfg.kv_lora_rank:]
    c_kv = vec_norm_apply(p["kv_norm"], c_kv, cfg.eps)

    cos, sin = rope_table(q_pos, dr, cfg.rope_theta)
    q_pe = rope_apply(q_pe, cos[None], sin[None])
    k_pe = rope_apply(k_pe[:, :, None, :], cos[None], sin[None])[:, :, 0]

    if cache is not None:
        start = int(cache_pos) if cache_pos is not None else 0
        _write(cache["ckv"], c_kv, start)
        _write(cache["kpe"], k_pe, start)
        c_kv, k_pe = cache["ckv"], cache["kpe"]
        kv_pos = torch.arange(c_kv.shape[1], device=x.device)
    else:
        kv_pos = q_pos

    kvb = torch.einsum("bsr,rhk->bshk", c_kv, p["wkv_b"])
    k_nope, v = kvb[..., :dn], kvb[..., dn:]

    mask = make_mask(q_pos, kv_pos, causal=True, kv_valid=kv_valid)
    out = _mla_core(q_nope, q_pe, k_nope, k_pe, v, mask)
    return _out_proj(out, p["wo"]), cache


def _mla_core(q_nope: torch.Tensor, q_pe: torch.Tensor, k_nope: torch.Tensor,
              k_pe: torch.Tensor, v: torch.Tensor, mask: torch.Tensor
              ) -> torch.Tensor:
    """MLA's attention over the decompressed keys: q_nope, q_pe [B,T,H,*],
    k_nope, v [B,S,H,*], the rotary key k_pe [B,S,dr] shared by the heads,
    mask [T,S] additive (f32).

    On DTensors it runs per shard, as :func:`_sdpa` does and for its
    reason: the batch and head shards are kept where the keys have them
    (or are replicated there and divide), the shared rotary key keeps the
    batch shards only."""
    if isinstance(q_nope, DTensor):
        mesh = q_nope.device_mesh

        def kept(i, p):
            kp = k_nope.placements[i]
            return any(p.is_shard(d) and (kp.is_shard(d) or (
                kp.is_replicate() and k_nope.shape[d] % mesh.size(i) == 0))
                for d in (0, 2))
        pl = tuple(p if kept(i, p) else Replicate()
                   for i, p in enumerate(q_nope.placements))
        pl_pe = tuple(p if p.is_shard(0) else Replicate() for p in pl)

        def local(t, placements, grad_placements=None):
            if not isinstance(t, DTensor):
                t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                       run_check=False)
            return t.redistribute(mesh, placements).to_local(
                grad_placements=grad_placements)
        # the shared key's gradient is summed over the head shards
        pe_grad = [Partial() if p.is_shard(2) else q
                   for p, q in zip(pl, pl_pe)]
        out = _mla_core(*(local(t, pl) for t in (q_nope, q_pe, k_nope)),
                        local(k_pe, pl_pe, pe_grad), local(v, pl),
                        mask).contiguous()  # the strides given below
        B, T, H, dv = q_nope.shape[:3] + v.shape[-1:]
        return DTensor.from_local(out, mesh, pl, run_check=False,
                                  shape=(B, T, H, dv),
                                  stride=(T * H * dv, H * dv, dv, 1))
    dn, dr = q_nope.shape[-1], q_pe.shape[-1]
    # a 0-d host tensor: the reference's scalar, with no copy to the card
    scale = 1.0 / torch.tensor(dn + dr, dtype=torch.float32).sqrt().to(
        q_nope.dtype)
    scores = (torch.einsum("bthk,bshk->bhts", q_nope, k_nope)
              + torch.einsum("bthk,bsk->bhts", q_pe, k_pe)) * scale
    scores = scores.float() + mask
    pr = torch.softmax(scores, dim=-1).to(q_nope.dtype)
    return torch.einsum("bhts,bshk->bthk", pr, v)


def empty_cache(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, *, device) -> Dict[str, torch.Tensor]:
    """Per-layer KV cache buffers (MLA: compressed latent)."""
    if cfg.mla:
        return {
            "ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "kpe": torch.zeros((batch, max_len, cfg.rope_head_dim),
                               dtype=dtype, device=device),
        }
    return {
        "k": torch.zeros((batch, max_len, cfg.n_kv, cfg.head_dim),
                         dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, cfg.n_kv, cfg.head_dim),
                         dtype=dtype, device=device),
    }
