"""Distributed-optimization collectives: gradient compression with error
feedback and hierarchical (pod-aware) reduction helpers.

In the sharded train step, gradient all-reduces come from DTensor's
redistributes; these helpers are for the explicit per-shard paths and for
the compression transform.

int8 error-feedback compression: g is quantised to int8 against a globally
agreed scale (one extra scalar all-reduce), summed in int32 (wraparound-safe
for ≤ 2^23 summands), and dequantised; the quantisation residual is carried
to the next step (error feedback), which keeps SGD/Adam convergence unbiased
in expectation.

The reference runs these inside ``shard_map`` and names its axes; here each
function takes the ``DeviceMesh`` and the axis names, and runs on every
rank on that rank's block.  A caller maps ``shard_map(f, mesh, in_specs,
out_specs)`` onto ``f(x.redistribute(mesh, placements(in_spec,
mesh)).to_local(), mesh, …)`` and wraps the result with
``DTensor.from_local(out, mesh, placements(out_spec, mesh))``; a plain
tensor that is the same on every rank is already its replicated block.
(``sharding.py`` has the table of JAX collectives and their torch names.)
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.distributed.sharding import axis_size

Axes = Union[str, Sequence[str]]


def _names(axis_names: Axes) -> Tuple[str, ...]:
    return (axis_names,) if isinstance(axis_names, str) else tuple(axis_names)


def _all_reduce(x: torch.Tensor, mesh: DeviceMesh, axis_names: Axes,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce over several mesh axes, one group after the
    other (exact for integers and MAX)."""
    for a in _names(axis_names):
        dist.all_reduce(x, op=op, group=mesh.get_group(a))
    return x


class _Psum(torch.autograd.Function):
    """``psum`` into a value replicated over the axes: the forward sums
    each rank's partial value; the backward passes the (replicated)
    cotangent through, as the transpose of a sum whose result is one
    value seen by every rank."""

    @staticmethod
    def forward(ctx, x, mesh, axis_names):
        return _all_reduce(x.clone(), mesh, axis_names)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Replicated(torch.autograd.Function):
    """A value replicated over the axes entering per-rank work: the forward
    is the identity; the backward sums the ranks' cotangents."""

    @staticmethod
    def forward(ctx, x, mesh, axis_names):
        ctx.mesh, ctx.axes = mesh, axis_names
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.mesh, ctx.axes), None, None


def psum(x: torch.Tensor, mesh: DeviceMesh, axis_names: Axes
         ) -> torch.Tensor:
    """Differentiable sum over mesh axes of per-rank partial values, the
    result replicated over them (its gradient is the cotangent itself)."""
    return _Psum.apply(x, mesh, axis_names)


def replicated(x: torch.Tensor, mesh: DeviceMesh, axis_names: Axes
               ) -> torch.Tensor:
    """Mark a replicated input of per-rank work: its gradient is summed
    over the axes."""
    return _Replicated.apply(x, mesh, axis_names)


def quantize_int8(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``round(g / scale)`` (half to even, as ``jnp.round``) clipped to
    ±127, as int8."""
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_int8_allreduce(g: torch.Tensor, err: torch.Tensor, mesh: DeviceMesh,
                      axis_names: Axes) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 all-reduce over ``axis_names`` of this rank's
    block ``g`` with its error state ``err``.

    Returns (mean gradient, new error state).
    """
    gf = g.to(torch.float32) + err
    global_max = _all_reduce(gf.abs().max(), mesh, axis_names,
                             op=dist.ReduceOp.MAX)
    scale = torch.clamp(global_max / 127.0, min=1e-12)
    q = quantize_int8(gf, scale)
    new_err = gf - dequantize_int8(q, scale)
    total = _all_reduce(q.to(torch.int32), mesh, axis_names)
    mean = dequantize_int8(total, scale) / axis_size(mesh, axis_names)
    return mean.to(g.dtype), new_err


def hierarchical_psum(x: torch.Tensor, mesh: DeviceMesh,
                      pod_axis: str = "pod", data_axis: str = "data"
                      ) -> torch.Tensor:
    """Pod-aware all-reduce: reduce-scatter in-pod → cross-pod all-reduce on
    the scattered shard → all-gather in-pod.  Moves only 1/data_size of the
    payload over the (slow) cross-pod links instead of the whole tensor.
    """
    n_data = axis_size(mesh, data_axis)
    x = x.contiguous()
    if x.shape[0] % n_data != 0:
        # fall back for indivisible leading dims
        return _all_reduce(x.clone(), mesh, (pod_axis, data_axis))
    shard = x.new_empty((x.shape[0] // n_data,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(shard, x, group=mesh.get_group(data_axis))
    dist.all_reduce(shard, group=mesh.get_group(pod_axis))
    out = torch.empty_like(x)
    dist.all_gather_into_tensor(out, shard, group=mesh.get_group(data_axis))
    return out


def init_error_state(grads) -> Dict:
    """f32 zeros shaped as each leaf of a tree of nested dicts."""
    if isinstance(grads, dict):
        return {k: init_error_state(v) for k, v in grads.items()}
    return torch.zeros(grads.shape, dtype=torch.float32, device=grads.device)
