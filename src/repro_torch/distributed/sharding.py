"""Logical-axis sharding rules (MaxText-style) and activation constraints,
on a ``torch.distributed`` ``DeviceMesh``.

Model code annotates tensors with *logical* axis names
(``shard(x, "batch", "seq", "embed")``); the launcher installs a rule set
mapping logical names to mesh axes.  Outside a mesh context, and on a
plain (non-DTensor) tensor, annotations are no-ops, so the same model code
runs on one device and on a mesh.

Default rules (single pod, mesh ("data", "model")):

    batch   → ("data",)          DP over the batch
    vocab   → ("model",)         TP over vocab rows (embed + lm head)
    heads   → ("model",)         TP over attention heads
    expert  → ("model",)         EP over routed experts
    mlp     → ("model",)         TP over the FFN hidden dim
    inner   → ("model",)         TP over SSM inner channels
    kv_heads→ ("model",)         TP over KV heads (skipped if indivisible)
    embed/seq/qk/stage/...       replicated by default

Multi-pod prepends the "pod" axis to ``batch`` (hierarchical DP).
``fsdp=True`` additionally shards the *embed / contraction* dimension of
weights over "data" (ZeRO-3 style).

The JAX → torch mapping of this package's distributed modules:

    =============================  =========================================
    JAX                            torch
    =============================  =========================================
    ``Mesh``                       ``DeviceMesh``
    ``NamedSharding`` +            ``distribute_tensor`` (here
    ``device_put``                 :func:`distribute_tree`)
    ``with_sharding_constraint``   ``DTensor.redistribute`` (:func:`shard`)
    ``shard_map``                  ``to_local`` → per-group collectives →
                                   ``DTensor.from_local``
    ``psum``                       ``all_reduce`` (differentiable as
                                   ``collectives.psum``: its backward passes
                                   the replicated cotangent through)
    ``pmax``                       ``all_reduce(MAX)``
    ``psum_scatter(tiled)``        ``reduce_scatter_tensor``
    ``all_gather(tiled)``          ``all_gather_into_tensor``
    ``ppermute``                   ``batch_isend_irecv``
    ``axis_index``                 ``mesh.get_local_rank(axis)``
    =============================  =========================================

Where GSPMD is free to pick any layout, DTensor needs a strategy for each
op.  These redistributes make the model stack's ops expressible; each keeps
the stored sharding (the gradient flows back into it):

* :func:`gather_fsdp` — a weight's FSDP axes (the mesh axes of
  ``embed_fsdp``) are gathered to ``Replicate`` at its use, as ZeRO-3 does.
  DTensor cannot look ids up in a ``[vocab@model, embed@data]`` table while
  the ids are sharded over ``data``; with the ``data`` axis gathered the
  lookup is a row-sharded embedding.  The stacked groups gather one layer's
  slice at a time (``transformer._scan_group``), inside remat, so the
  backward gathers it again.
* :func:`shard` reduces a pending partial sum (the row-sharded embedding's
  output, a contraction over a sharded dim) when it lays an activation out
  by its logical axes; the embedding's output passes through
  ``shard(x, "batch", "seq", None)`` before any other op sees it.
* ``train_loop.cross_entropy_loss`` gathers vocab-sharded logits before
  its gold-logit gather, as SPMD does for ``take_along_axis``.
* ``attention._sdpa`` and ``attention._out_proj`` run per shard
  (``shard_map``'s mapping): DTensor's ``bmm`` strategy on a batch and a
  head dim flattened into one strided dim plans its redistribution by a
  graph search that grows with the mesh.

Inside :func:`sharding_rules` with a mesh, plain tensors that the model
makes (positions, masks, rope tables, scalars) take part in DTensor ops as
replicated values (DTensor's ``implicit_replication``), as constants do
under ``jit``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

_state = threading.local()


class PartitionSpec(tuple):
    """The reference's ``PartitionSpec``: one entry per tensor dim, each a
    mesh axis name, a tuple of names, or None (replicated)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("data",),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "expert": ("model",),
    "mlp": ("model",),
    "inner": ("model",),
    "embed": (),
    "embed_fsdp": (),      # weights' contraction dim; ("data",) under FSDP
    "seq": (),
    "kv_seq": (),
    "qk": (),
    "state": (),
    "frames": (),
    "image": (),
    "layers": (),
}


def multi_pod_rules(fsdp: bool = False) -> Dict[str, Tuple[str, ...]]:
    rules = dict(DEFAULT_RULES)
    rules["batch"] = ("pod", "data")
    if fsdp:
        rules["embed_fsdp"] = ("data",)
    return rules


def single_pod_rules(fsdp: bool = False) -> Dict[str, Tuple[str, ...]]:
    rules = dict(DEFAULT_RULES)
    if fsdp:
        rules["embed_fsdp"] = ("data",)
    return rules


@contextlib.contextmanager
def sharding_rules(mesh: Optional[DeviceMesh],
                   rules: Dict[str, Tuple[str, ...]]):
    """Install (mesh, rules) for `shard()` / `logical_spec()` lookups."""
    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, rules)
    try:
        with (implicit_replication() if mesh is not None
              else contextlib.nullcontext()):
            yield
    finally:
        _state.ctx = prev


def current_mesh() -> Optional[DeviceMesh]:
    ctx = getattr(_state, "ctx", None)
    return ctx[0] if ctx else None


def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    """``{axis name: size}``, the reference's ``Mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def logical_spec(*logical: Optional[str]) -> PartitionSpec:
    """Resolve logical axis names to a PartitionSpec under current rules.

    An axis is dropped (replicated) when its rule is empty or the named
    dimension is not divisible by the mesh extent — checked by callers that
    know the dim size via ``logical_spec_for_shape``.
    """
    ctx = getattr(_state, "ctx", None)
    if ctx is None:
        return P()
    _, rules = ctx
    parts = []
    for name in logical:
        if name is None:
            parts.append(None)
            continue
        axes = rules.get(name, ())
        parts.append(tuple(axes) if len(axes) > 1 else (axes[0] if axes else None))
    return P(*parts)


def axis_size(mesh: DeviceMesh, axes) -> int:
    """Ranks along one mesh axis, or the product over several (a spec
    entry: a name, a tuple of names, or None for 1)."""
    if axes is None:
        return 1
    shape = mesh_shape(mesh)
    n = 1
    for a in ((axes,) if isinstance(axes, str) else axes):
        n *= shape[a]
    return n


def logical_spec_for_shape(shape: Sequence[int],
                           *logical: Optional[str]) -> PartitionSpec:
    """Like ``logical_spec`` but drops mesh axes that do not divide the
    corresponding dimension (e.g. kv_heads=1 cannot shard over model=16)."""
    ctx = getattr(_state, "ctx", None)
    if ctx is None:
        return P()
    mesh, _ = ctx
    spec = logical_spec(*logical)
    if mesh is None:
        return spec
    parts = []
    for dim, axes in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        ext = axis_size(mesh, axes)
        parts.append(axes if ext > 1 and dim % ext == 0 else None)
    return P(*parts)


def placements(spec: Sequence, mesh: DeviceMesh) -> Tuple[Placement, ...]:
    """One ``Shard(dim)`` or ``Replicate()`` per mesh dim for a
    PartitionSpec.  A tensor dim over several mesh axes (``("pod",
    "data")``) is split by them major to minor, which is DTensor's order
    when they are named in mesh order."""
    names = mesh.mesh_dim_names
    out = [Replicate() for _ in names]
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {axes} is not in the mesh's axis "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


class _GradLaidOut(torch.autograd.Function):
    """The identity on a DTensor whose gradient is redistributed to the
    DTensor's own placements (a pending partial sum reduced), as the
    reference's ``with_sharding_constraint`` constrains the cotangent."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) == tuple(ctx.placements):
            return g
        return g.redistribute(ctx.mesh, ctx.placements)


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Apply a logical-axis sharding constraint: ``redistribute`` a DTensor
    to the placements of its logical axes; the identity without a mesh or
    on a plain tensor.  The gradient is laid out the same way before it
    flows back, as JAX transposes the constraint: DTensor cannot turn a
    partial gradient into the row-sharded embedding's masked partial, nor
    unflatten a gradient sharded unevenly over the heads."""
    ctx = getattr(_state, "ctx", None)
    if ctx is None or ctx[0] is None or not isinstance(x, DTensor):
        return x
    mesh, _ = ctx
    spec = logical_spec_for_shape(x.shape, *logical)
    out = x.redistribute(mesh, placements(spec, mesh))
    if x.requires_grad:
        out = _GradLaidOut.apply(out)
    return out


def gather_fsdp(tree):
    """A weight tree at its use: each DTensor leaf with the mesh axes of
    the ``embed_fsdp`` rule gathered to ``Replicate`` (ZeRO-3's gather at
    use); its gradient goes back to the stored sharding (a reduce-scatter).
    The identity without a mesh or FSDP rule, and on plain tensors."""
    ctx = getattr(_state, "ctx", None)
    if ctx is None or ctx[0] is None or not ctx[1].get("embed_fsdp"):
        return tree
    mesh, rules = ctx
    gathered = [mesh.mesh_dim_names.index(a) for a in rules["embed_fsdp"]]

    def one(t):
        if isinstance(t, dict):
            return {k: one(v) for k, v in t.items()}
        if not isinstance(t, DTensor) or all(
                not t.placements[i].is_shard() for i in gathered):
            return t
        pl = list(t.placements)
        for i in gathered:
            pl[i] = Replicate()
        return t.redistribute(t.device_mesh, pl)
    return one(tree)


class NamedSharding(NamedTuple):
    """The reference's ``NamedSharding``: a mesh and one placement per mesh
    dim."""
    mesh: DeviceMesh
    placements: Tuple[Placement, ...]


def named_sharding(mesh: DeviceMesh, *spec_parts) -> NamedSharding:
    return NamedSharding(mesh, placements(P(*spec_parts), mesh))


def distribute_tree(tree, specs, mesh: DeviceMesh):
    """``jax.device_put`` of a tree onto ``NamedSharding(mesh, spec)``
    leaves: nested dicts of tensors (the same on every rank) and a
    matching tree of PartitionSpecs → DTensor leaves on ``mesh``."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs[k], mesh) for k, v in tree.items()}
    return distribute_tensor(tree, mesh, placements(specs, mesh))
