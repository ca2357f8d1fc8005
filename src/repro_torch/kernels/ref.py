"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each function is the mathematical definition its hand-written kernel must
match: the CPU tests run these, and the GPU check holds each kernel
against its plain version on the same inputs.  They follow the JAX
package's oracles (``src/repro/kernels/ref.py``) step for step, including
where a bfloat16 product is rounded.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def chunked_matmul(x: torch.Tensor, w: torch.Tensor,
                   layout: str = "row") -> torch.Tensor:
    """C = X Wᵀ — the paper's MatMul-as-join+γ. x [M,K], w [N,K] → [M,N],
    accumulated in float32 and returned in ``x.dtype``.  In the column
    layouts (``layout="col"``) w is [H, K, Nh], H column blocks of the
    transposed weight, and C [M, H·Nh] = X·w[h] block by block."""
    if layout == "col":
        M, H = x.shape[0], w.shape[0]
        return (x.float() @ w.float()).permute(1, 0, 2).reshape(
            M, H * w.shape[2]).to(x.dtype)
    return (x.float() @ w.float().T).to(x.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q [B,H,T,d], k/v [B,Hkv,S,d] → [B,H,T,d].  The causal mask places
    query row t at position ``t + q_offset``: it sees keys s ≤ t + q_offset.
    At ``q_offset = 0`` the mask is top-left aligned, so T < S is legal (a
    prefill over a deeper cache); a suffix prefill passes the number of
    cached prefix rows.  Key/value heads are expanded to ``H`` with
    ``repeat_interleave(H // Hkv)`` (query head h reads key head
    ``h // (H/Hkv)``); with ``Hkv == H`` and ``q_offset = 0`` this is the JAX
    oracle's signature."""
    H, T, d = q.shape[1], q.shape[2], q.shape[3]
    Hkv, S = k.shape[1], k.shape[2]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=1)
        v = v.repeat_interleave(H // Hkv, dim=1)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    s = torch.einsum("bhtd,bhsd->bhts", q, k).float() * scale
    if causal:
        mask = (torch.arange(T, device=q.device)[:, None] + q_offset
                >= torch.arange(S, device=q.device)[None, :])
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", p.to(q.dtype), v)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention over KV-cache tables (paper §3.4).

    q          [B, H, d]           one query token per sequence
    k/v_pool   [P, page, Hkv, d]   the pooled cache pages
    page_table [B, max_pages]      per-sequence page ids (-1 unmapped)
    lengths    [B]                 valid tokens per sequence
    → [B, H, d]

    As the JAX oracle, an unmapped page reads page 0 and the mask is by
    length alone, so a sequence of length 0 gets the mean of V.  The kernel
    instead skips unmapped pages and gives zeros at length 0; the two agree
    whenever every page below ``length`` is mapped and ``length ≥ 1``.
    """
    B, H, d = q.shape
    page, Hkv = k_pool.shape[1], k_pool.shape[2]
    max_pages = page_table.shape[1]
    g = H // Hkv
    scale = 1.0 / (d ** 0.5)

    pt = torch.where(page_table < 0, 0, page_table).long()
    k = k_pool[pt].reshape(B, max_pages * page, Hkv, d)
    v = v_pool[pt].reshape(B, max_pages * page, Hkv, d)
    qg = q.reshape(B, Hkv, g, d)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k).float() * scale
    valid = (torch.arange(max_pages * page, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(q.dtype), v)
    return out.reshape(B, H, d)
