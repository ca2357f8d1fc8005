"""AdamW on the port's trees (nested dicts of tensors), with pluggable
state dtype.

The reference's arithmetic: the schedule runs in f32 on a 0-d ``int32``
step, the bias corrections are f32, each leaf's update is computed in f32
and cast back to the parameter dtype and to ``state_dtype``, and weight
decay applies to leaves of two or more dims (the stacked ``[L, d]`` norm
scales included, as in the reference).  Leaves are walked in JAX's order
(sorted keys, depth first), so ``global_norm`` adds its per-leaf sums in
the reference's order.

Unlike the reference, ``update`` and ``clip_by_global_norm`` write their
results into the tensors they are given (under ``torch.no_grad``), a
bounded slice of a leaf at a time: a functional update would hold the old
and new state together (57.8 GB of f32 moments alone at Llama-3.2-3B).
The numbers are the same; the returned trees are the ones given.

On DTensor leaves (a sharded train step) the state is placed as its
parameter, and the update and the clip's scaling, both elementwise, run on
each leaf's local shard (``to_local()``: a sharded DTensor has no flat
view).  ``global_norm`` takes each leaf's sum of squares as DTensor
computes it, so a replicated dim is counted once, and reads its value with
``full_tensor()``; weight decay reads the leaf's global rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.layers import DTYPES
from repro_torch.models.transformer import tree_leaves, tree_map

# elements of one leaf updated at a time: the f32 temporaries of an
# update stay a few times 256 MB whatever the leaf's size
CHUNK = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view of its storage); a plain tensor."""
    return t.to_local() if isinstance(t, DTensor) else t


def _chunks(*tensors: torch.Tensor) -> Iterator[Tuple[torch.Tensor, ...]]:
    """The same flat slices of at most ``CHUNK`` elements of tensors of
    one shape, as views; the whole tensors at once unless all are
    contiguous."""
    if not all(t.is_contiguous() for t in tensors):
        yield tensors
        return
    flat = [t.view(-1) for t in tensors]
    for s in range(0, flat[0].numel(), CHUNK):
        yield tuple(f[s: s + CHUNK] for f in flat)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: str = "float32"
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        """Linear warmup → cosine decay."""
        step = step.float()
        warm = torch.clamp(step / max(1, self.warmup_steps), max=1.0)
        prog = torch.clamp((step - self.warmup_steps)
                           / max(1, self.total_steps - self.warmup_steps),
                           0, 1)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return self.lr * warm * (self.min_lr_ratio
                                 + (1 - self.min_lr_ratio) * cos)

    def init(self, params) -> AdamWState:
        dt = DTYPES[self.state_dtype]
        leaf = next(tree_leaves(params))

        def z(p):  # placed as p on a mesh
            return torch.zeros_like(p, dtype=dt,
                                    memory_format=torch.contiguous_format)
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32,
                             device=_local(leaf).device),
            m=tree_map(z, params), v=tree_map(z, params))

    def update(self, grads, state: AdamWState, params
               ) -> Tuple[Any, AdamWState]:
        """One step: ``params``, ``state.m`` and ``state.v`` are written in
        place and returned with the new step."""
        step = state.step + 1
        lr = self.schedule(step)
        b1, b2 = self.b1, self.b2
        t = step.float()
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        with torch.no_grad():
            for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.m),
                                  tree_leaves(state.v), tree_leaves(params)):
                decay = self.weight_decay and p.ndim >= 2  # matrices only
                for gc, mc, vc, pc in _chunks(_local(g).contiguous(),
                                              _local(m), _local(v),
                                              _local(p)):
                    gf = gc.float()
                    mf = b1 * mc.float() + (1 - b1) * gf
                    vf = b2 * vc.float() + (1 - b2) * gf.square()
                    mhat = mf / bc1
                    vhat = vf / bc2
                    delta = mhat / (vhat.sqrt() + self.eps)
                    if decay:
                        delta = delta + self.weight_decay * pc.float()
                    pc.copy_(pc.float() - lr * delta)
                    mc.copy_(mf)
                    vc.copy_(vf)
        return params, AdamWState(step=step, m=state.m, v=state.v)


def _sum_squares(leaf: torch.Tensor) -> torch.Tensor:
    s = leaf.float().square().sum()
    return s.full_tensor() if isinstance(s, DTensor) else s


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(_sum_squares(l) for l in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """Scales ``grads`` in place (each leaf through f32, back to its dtype)
    so that their global norm is at most ``max_norm``; returns (grads, the
    norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    with torch.no_grad():
        for g in tree_leaves(grads):
            for (c,) in _chunks(_local(g)):
                c.copy_(c.float() * scale)
    return grads, norm
