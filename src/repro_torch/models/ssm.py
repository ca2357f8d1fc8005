"""Mamba-2 SSD (state-space duality) block — chunked scan formulation.

Training/prefill uses the SSD block decomposition (arXiv:2405.21060 §6):
within a chunk the recurrence is evaluated as a masked attention-like
contraction (intra-chunk), and chunk-granular states are carried by a loop
over the chunks (inter-chunk; the reference's ``lax.scan``).  Decode keeps a
constant-size recurrent state [B, nh, hd, S] plus a depthwise-conv ring
buffer — the paper's KV-cache table degenerates to a fixed-row *state
table*.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import shard
from repro_torch.models.layers import DTYPES, dense_init, normal


def ssm_init(gen, cfg: ModelConfig, *, device) -> Dict:
    d = cfg.d_model
    di = cfg.d_inner
    G, S = cfg.ssm_ngroups, cfg.ssm_state
    nh = cfg.ssm_heads
    conv_ch = di + 2 * G * S
    pdt = DTYPES[cfg.param_dtype]
    in_proj = dense_init(gen, d, 2 * di + 2 * G * S + nh, cfg, device=device)
    conv_w = (normal(gen, (cfg.ssm_conv, conv_ch), device=device) * 0.1
              ).to(pdt)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(torch.rand(nh, generator=gen, dtype=torch.float32,
                              device=device) * (hi - lo) + lo)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros(conv_ch, dtype=pdt, device=device),
        "A_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                        device=device)),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "D": torch.ones(nh, dtype=torch.float32, device=device),
        "norm_scale": torch.ones(di, dtype=pdt, device=device),
        "out_proj": dense_init(gen, di, d, cfg, device=device),
    }


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv over time. xBC [B,T,C], w [cw,C].  On
    DTensors it runs per shard (channels are independent): xBC keeps its
    batch and channel shards, w and b the channel shards; w's and b's
    gradients are summed over the batch shards."""
    if isinstance(xBC, DTensor):
        mesh = xBC.device_mesh
        pl = [p if p.is_shard(0) or p.is_shard(2) else Replicate()
              for p in xBC.placements]
        w_pl = [Shard(1) if p.is_shard(2) else Replicate() for p in pl]
        b_pl = [Shard(0) if p.is_shard(2) else Replicate() for p in pl]

        def local(t, placements):
            if not isinstance(t, DTensor):
                t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                       run_check=False)
            return t.redistribute(mesh, placements).to_local(
                grad_placements=[Partial() if p.is_shard(0) else q
                                 for p, q in zip(pl, placements)])
        out = _causal_conv(xBC.redistribute(mesh, pl).to_local(),
                           local(w, w_pl), local(b, b_pl)).contiguous()
        return DTensor.from_local(out, mesh, pl, run_check=False,
                                  shape=xBC.shape,
                                  stride=_contiguous_stride(xBC.shape))
    cw = w.shape[0]
    pad = F.pad(xBC, (0, 0, cw - 1, 0))
    out = torch.zeros_like(xBC)
    for i in range(cw):
        out = out + pad[:, i: i + xBC.shape[1], :] * w[i]
    return out + b


def _split_proj(p, x, cfg: ModelConfig):
    di, G, S = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di: 2 * di + 2 * G * S]
    dt = zxbcdt[..., 2 * di + 2 * G * S:]
    return z, xBC, dt


def _gated_out(p, y, z, cfg: ModelConfig):
    y = y * F.silu(z)
    yf = y.float()
    # a mean over the model-sharded inner channels: reduced whole on a mesh
    # (DTensor would reduce-scatter the pending sum over the sequence)
    var = shard(yf.square().mean(-1, keepdim=True), "batch", None, None)
    y = yf * torch.rsqrt(var + cfg.eps)
    y = (y * p["norm_scale"].float()).to(z.dtype)
    return y @ p["out_proj"]


def chunk_len(T: int, ssm_chunk: int) -> int:
    """The largest chunk ≤ ``ssm_chunk`` that divides T exactly (keeps the
    boundary state at position T exact for prefill continuation): a prime
    T gives 1."""
    return max(d for d in range(1, min(ssm_chunk, T) + 1) if T % d == 0)


def ssm_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig,
              initial_state: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence SSD. Returns (y [B,T,D], final_state [B,nh,hd,S])."""
    B, T, _ = x.shape
    di, G, S = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    nh, hd = cfg.ssm_heads, cfg.ssm_head_dim
    Q = chunk_len(T, cfg.ssm_chunk)

    z, xBC, dt = _split_proj(p, x, cfg)
    xBC = F.silu(_causal_conv(xBC, p["conv_w"], p["conv_b"]))
    xs = xBC[..., :di].reshape(B, T, nh, hd)
    B_ = xBC[..., di: di + G * S].reshape(B, T, G, S)
    C_ = xBC[..., di + G * S:].reshape(B, T, G, S)
    xs = shard(xs, "batch", None, "inner", None)

    dt = F.softplus(dt.float() + p["dt_bias"])  # [B,T,nh]
    A = -torch.exp(p["A_log"])  # [nh]
    y, carry = _ssd(xs, dt, A, B_, C_, p["D"], initial_state, Q)
    y = shard(y.reshape(B, T, di), "batch", None, None)
    return _gated_out(p, y, z, cfg), carry


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, n = [], 1
    for d in reversed(shape):
        stride.append(n)
        n *= d
    return tuple(reversed(stride))


def _ssd(xs: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
         B_: torch.Tensor, C_: torch.Tensor, D: torch.Tensor,
         initial_state: Optional[torch.Tensor], Q: int
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan: xs [B,T,nh,hd], dt [B,T,nh] (f32, after the
    softplus), A and D [nh], B_ and C_ [B,T,G,S], the entering state
    [B,nh,hd,S] or None, chunks of Q → (y [B,T,nh,hd], final state).

    On DTensors it runs per shard, as ``shard_map`` would (and as the
    attention core does, for the same reason: DTensor's ``bmm`` on a batch
    and a head dim flattened into one strided dim): xs keeps its batch
    shards, and its head shards when there is one group (every head reads
    the same B and C); B and C keep the batch shards, A and D the head
    shards, the state both.  A gradient computed in parts (B and C's over
    the head shards, A and D's over the batch shards) is summed."""
    if isinstance(xs, DTensor):
        mesh = xs.device_mesh
        G = B_.shape[2]
        pl = tuple(p if p.is_shard(0) or (p.is_shard(2) and G == 1)
                   else Replicate() for p in xs.placements)
        pl_bc = tuple(p if p.is_shard(0) else Replicate() for p in pl)
        pl_head = tuple(Shard(0) if p.is_shard(2) else Replicate()
                        for p in pl)
        pl_state = tuple(Shard(1) if p.is_shard(2) else p for p in pl)

        def local(t, placements, partial_on=None):
            """t's block; its gradient summed over the mesh dims where
            ``pl`` shards dim ``partial_on`` (each rank computed part)."""
            if t is None:
                return None
            if not isinstance(t, DTensor):
                t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                       run_check=False)
            return t.redistribute(mesh, placements).to_local(grad_placements=[
                Partial() if partial_on is not None and p.is_shard(
                    partial_on) else q for p, q in zip(pl, placements)])
        y, carry = _ssd(local(xs, pl), local(dt, pl),
                        local(A, pl_head, 0), local(B_, pl_bc, 2),
                        local(C_, pl_bc, 2), local(D, pl_head, 0),
                        local(initial_state, pl_state), Q)
        Bt, T, nh, hd = xs.shape
        S = B_.shape[-1]
        y, carry = y.contiguous(), carry.contiguous()  # the strides given
        return (DTensor.from_local(y, mesh, pl, run_check=False,
                                   shape=xs.shape,
                                   stride=_contiguous_stride(xs.shape)),
                DTensor.from_local(carry, mesh, pl_state, run_check=False,
                                   shape=(Bt, nh, hd, S),
                                   stride=_contiguous_stride(
                                       (Bt, nh, hd, S))))
    B, T, nh, hd = xs.shape
    G, S = B_.shape[2], B_.shape[3]
    NC = T // Q
    hpg = nh // G
    f32, dtype = torch.float32, xs.dtype
    dA = dt * A  # [B,T,nh] log-decay per step

    # chunk views
    dA_c = dA.reshape(B, NC, Q, nh)
    seg = torch.cumsum(dA_c, dim=2)                           # [B,NC,Q,nh]
    x_c = xs.reshape(B, NC, Q, nh, hd)
    Bh = B_.reshape(B, NC, Q, G, S).repeat_interleave(hpg, dim=3)
    Ch = C_.reshape(B, NC, Q, G, S).repeat_interleave(hpg, dim=3)
    dt_c = dt.reshape(B, NC, Q, nh)
    xdt = x_c * dt_c[..., None].to(x_c.dtype)

    # ---- intra-chunk (the "duality": masked attention over the chunk) ------
    # exp of the upper triangle may overflow to inf; the where drops it
    dseg = seg[:, :, :, None, :] - seg[:, :, None, :, :]     # [B,NC,Q,Q,nh]
    tril = torch.ones(Q, Q, dtype=torch.bool, device=xs.device).tril()
    L = torch.where(tril[None, None, :, :, None], torch.exp(dseg), 0.0)
    CB = torch.einsum("bcqhs,bckhs->bcqkh", Ch.to(f32), Bh.to(f32))
    M = CB * L
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", M.to(dtype), xdt)

    # ---- chunk states + inter-chunk recurrence ------------------------------
    decay_to_end = torch.exp(seg[:, :, -1:, :] - seg)         # [B,NC,Q,nh]
    states = torch.einsum("bcqhs,bcqhp->bchps",
                          (Bh.to(f32) * decay_to_end[..., None]).to(dtype),
                          xdt)
    chunk_decay = torch.exp(seg[:, :, -1, :])                 # [B,NC,nh]

    carry = initial_state if initial_state is not None else torch.zeros(
        (B, nh, hd, S), dtype=dtype, device=xs.device)
    prev = []
    for c in range(NC):  # emit the state *entering* each chunk
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None].to(carry.dtype) \
            + states[:, c]
    prev_states = torch.stack(prev, dim=1)                   # [B,NC,nh,hd,S]

    y_inter = torch.einsum("bcqhs,bchps->bcqhp",
                           (Ch.to(f32) * torch.exp(seg)[..., None]).to(
                               dtype), prev_states)

    y = (y_intra + y_inter).reshape(B, T, nh, hd)
    y = y + x_c.reshape(B, T, nh, hd) * D[:, None].to(dtype)
    return y, carry


def ssm_decode_step(p: Dict, x: torch.Tensor, state: Dict[str, torch.Tensor],
                    cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token recurrent update.

    state = {"ssm": [B,nh,hd,S], "conv": [B,cw-1,conv_ch]}.
    x: [B, 1, D].
    """
    B = x.shape[0]
    di, G, S = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    nh, hd = cfg.ssm_heads, cfg.ssm_head_dim
    hpg = nh // G

    z, xBC, dt = _split_proj(p, x[:, 0], cfg)
    window = torch.cat([state["conv"], xBC[:, None, :]], dim=1)
    xBC = F.silu(torch.einsum("bwc,wc->bc", window, p["conv_w"])
                 + p["conv_b"])
    new_conv = window[:, 1:]

    xs = xBC[..., :di].reshape(B, nh, hd)
    B_ = xBC[..., di: di + G * S].reshape(B, G, S).repeat_interleave(hpg, 1)
    C_ = xBC[..., di + G * S:].reshape(B, G, S).repeat_interleave(hpg, 1)

    dt = F.softplus(dt.float() + p["dt_bias"])                 # [B,nh]
    dA = torch.exp(dt * -torch.exp(p["A_log"]))                # [B,nh]
    upd = torch.einsum("bhs,bhp->bhps", B_, xs * dt[..., None].to(x.dtype))
    new_state = state["ssm"] * dA[:, :, None, None].to(x.dtype) + upd
    y = torch.einsum("bhs,bhps->bhp", C_, new_state)
    y = y + xs * p["D"][:, None].to(x.dtype)
    y = y.reshape(B, 1, di)
    out = _gated_out(p, y, z[:, None, :], cfg)
    return out, {"ssm": new_state, "conv": new_conv}


def empty_ssm_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16, *,
                    device) -> Dict[str, torch.Tensor]:
    conv_ch = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return {
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                            cfg.ssm_state), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                            device=device),
    }
