"""Pipeline parallelism over the ``pod`` (or any) mesh axis.

GPipe-style schedule: layer groups are split over the stage axis;
microbatches stream through the stages, activations hop stage→stage
(``batch_isend_irecv``, the reference's ``ppermute``).  Differentiable: the
hop's backward sends the gradient the other way (the transpose of a
permute is the reverse permute), and the last stage's output reaches every
stage by a sum of the masked outputs whose backward hands each rank the
cotangent (:func:`collectives.psum`), so the same function serves training.

This is the alternative use of the multi-pod axis: DP across pods costs one
cross-pod all-reduce of the full gradient per step, PP costs microbatch
activations per hop — for large models with modest global batch, PP wins
on the slow cross-pod links.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.collectives import psum, replicated
from repro_torch.models.transformer import tree_leaves, tree_map


def _hop(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``x`` to the group rank ``step`` ahead (cyclically) and return
    what the rank ``step`` behind sent."""
    me, n = dist.get_rank(group), dist.get_world_size(group)
    if n == 1:
        return x.clone()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(),
                      dist.get_global_rank(group, (me + step) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (me - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Permute(torch.autograd.Function):
    """``ppermute`` to the next stage; the backward to the previous one."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _hop(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _hop(g, ctx.group, -1), None


def _stage_slice(leaf: torch.Tensor, mesh: DeviceMesh, stage_axis: str,
                 stage: int, n_stages: int) -> torch.Tensor:
    """This stage's layers of a stacked leaf: a DTensor's local shard with
    its layer axis split over the stage axis, or the rows of a plain tensor
    (the same on every rank)."""
    if isinstance(leaf, DTensor):
        pl = [Shard(0) if name == stage_axis else Replicate()
              for name in mesh.mesh_dim_names]
        return leaf.redistribute(mesh, pl).to_local()
    per = leaf.shape[0] // n_stages
    return leaf[stage * per: (stage + 1) * per]


def pipeline_apply(
    block_fn: Callable,          # (params_one_layer, x) -> x
    stacked_params,              # leaves [n_layers, ...]
    x: torch.Tensor,             # [n_micro * micro_bs, ...]
    mesh: DeviceMesh,
    stage_axis: str = "pod",
    n_micro: int = 4,
) -> torch.Tensor:
    """Run ``n_layers`` blocks as a pipeline over the stage axis.

    n_layers must divide by the number of stages; the global batch splits
    into ``n_micro`` microbatches.  Schedule: S + M - 1 ticks (GPipe fill +
    drain); stage s processes microbatch m at tick s + m.  ``x`` and the
    result are plain tensors, the same on every rank (the reference's
    replicated ``in_specs``/``out_specs``); the stacked leaves are plain
    tensors or DTensors on ``mesh``.
    """
    group = mesh.get_group(stage_axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(stage_axis))
    stage = mesh.get_local_rank(stage_axis)
    n_layers = next(tree_leaves(stacked_params)).shape[0]
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split over {n_stages} "
                         f"stages")
    per_stage = n_layers // n_stages
    params_slice = tree_map(
        lambda l: _stage_slice(l, mesh, stage_axis, stage, n_stages),
        stacked_params)
    unbound = tree_map(lambda l: torch.unbind(l, 0), params_slice)
    layers = [tree_map(lambda ls: ls[i], unbound) for i in range(per_stage)]

    # every rank builds the same graph (masks, not branches), so each
    # hop's backward runs on every rank in the same order
    first = torch.tensor(stage == 0, device=x.device)
    last = torch.tensor(stage == n_stages - 1, device=x.device)
    micro = torch.chunk(replicated(x, mesh, stage_axis), n_micro, dim=0)
    n_ticks = n_stages + n_micro - 1
    buf = torch.zeros_like(micro[0])
    outs = [torch.zeros_like(m) for m in micro]
    for tick in range(n_ticks):
        # stage 0 injects microbatch `tick` (if any)
        inject = micro[tick] if tick < n_micro else torch.zeros_like(buf)
        y = torch.where(first, inject, buf)
        for p_l in layers:
            y = block_fn(p_l, y)
        # pass activations to the next stage
        buf = _Permute.apply(y, group)
        # last stage emits microbatch tick - (n_stages - 1)
        out_idx = tick - (n_stages - 1)
        if 0 <= out_idx < n_micro:
            outs[out_idx] = torch.where(last, y, outs[out_idx])

    out = torch.cat(outs, dim=0)
    # broadcast the last stage's result to every stage
    return psum(torch.where(last, out, torch.zeros_like(out)), mesh,
                stage_axis)
