"""Training step: loss, gradients, optimizer update, on one device or a
mesh.

``make_train_step`` builds ``train_step(params, opt_state, batch)``.
Gradients come from ``torch.autograd.grad`` over the parameter leaves in
JAX's order, as a tree like ``jax.value_and_grad``'s (no ``.grad``
buffers stay alive), in the parameters' dtype; gradient accumulation runs
the microbatches (contiguous slices of the batch) one after another into
f32 accumulators.  The clip and the AdamW update then write into the
gradients, the parameters and the optimizer state in place.

The same step runs on a sharded tree, as ``jax.jit(step)`` does on the
reference's: inside ``sharding_rules(mesh, rules)``, place the parameters
with ``distribute_tree(params, param_pspecs(params, mesh), mesh)`` and the
batch by ``batch_pspec()``; ``opt.init`` gives moments placed as their
parameters.  Each gradient comes back in its parameter's placements (the
data-parallel sum is the backward of DTensor's redistributes), and the
loss is reduced to a replicated scalar before the gradient is taken.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (current_mesh, logical_spec,
                                              logical_spec_for_shape, P,
                                              shard)
from repro_torch.models import transformer as tf
from repro_torch.training.optimizer import (AdamW, AdamWState,
                                            clip_by_global_norm)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       impl: str = "gather") -> torch.Tensor:
    """Token-mean softmax cross entropy in f32.

    impl="gather": the gold logit gathered along the vocab axis.  On a
    model-sharded vocab axis the logits are first gathered whole
    (``shard(logits, "batch", None, None)``), as SPMD replicates them for
    the reference's ``take_along_axis``: DTensor cannot reduce the masked
    partial result of a gather along a sharded dim.
    impl="onehot": the gold logit as a masked reduction over the vocab
    axis (the reference's choice for a model-sharded vocab axis; one device
    computes the same value).
    """
    if impl != "onehot":
        logits = shard(logits, "batch", None, None)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    if impl == "onehot":
        V = logits.shape[-1]
        onehot = (labels[..., None] == torch.arange(
            V, dtype=labels.dtype, device=labels.device)).to(logits.dtype)
        gold = torch.sum(logits * onehot, dim=-1)
    else:
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(mask.sum().float(),
                                                   min=1.0)
    return torch.mean(nll)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    batch = dict(batch, tokens=batch["tokens"].long())
    logits = tf.forward(params, batch, cfg)
    loss = cross_entropy_loss(logits, batch["labels"], batch.get("mask"),
                              impl=cfg.ce_impl)
    if isinstance(loss, DTensor):  # a pending partial sum → its value
        loss = loss.redistribute(loss.device_mesh,
                                 [Replicate()] * loss.device_mesh.ndim)
    metrics = {"loss": loss}
    return loss, metrics


def make_train_step(cfg: ModelConfig, opt: AdamW,
                    grad_accum: int = 1,
                    clip_norm: float = 1.0) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), the parameters and state updated in place. The batch's
    leading dim must divide by grad_accum."""

    def single_grads(params, mb):
        live = [p.detach().requires_grad_(True)
                for p in tf.tree_leaves(params)]
        # on a mesh the backward runs on this thread: the autograd engine
        # would run a CUDA backward (and remat's recompute of each layer)
        # on its device thread, where the thread-local sharding rules and
        # DTensor's implicit replication of plain tensors are off
        on_mesh = current_mesh() is not None
        with torch.enable_grad():
            loss, metrics = loss_fn(tf.tree_unflatten(params, live), mb, cfg)
            with torch.autograd.set_multithreading_enabled(not on_mesh):
                grads = torch.autograd.grad(loss, live, allow_unused=True,
                                            materialize_grads=True)
        return ([_placed_as(g, p) for g, p in zip(grads, live)],
                {k: v.detach() for k, v in metrics.items()})

    def train_step(params, opt_state: AdamWState, batch):
        if grad_accum == 1:
            grads, metrics = single_grads(params, batch)
        else:
            acc = [torch.zeros_like(p, dtype=torch.float32,
                                    memory_format=torch.contiguous_format)
                   for p in tf.tree_leaves(params)]
            ms = []
            for i in range(grad_accum):
                mb = {}
                for k, v in batch.items():
                    size = v.shape[0] // grad_accum
                    mb[k] = v[i * size: (i + 1) * size]
                g, m = single_grads(params, mb)
                for a, b in zip(acc, g):
                    a.add_(b.to(a.dtype))
                del g
                ms.append(m)
            grads = [a.div_(grad_accum) for a in acc]
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}

        grads, gnorm = clip_by_global_norm(tf.tree_unflatten(params, grads),
                                           clip_norm)
        new_params, new_state = opt.update(grads, opt_state, params)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = opt.schedule(new_state.step)
        return new_params, new_state, metrics

    return train_step


def _placed_as(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient in its parameter's placements (a partial sum is
    reduced); plain tensors as they are."""
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


# ---------------------------------------------------------------------------
# Sharding trees
# ---------------------------------------------------------------------------

_RULES = [
    # (path substrings, shape-rank) -> logical axes per dim
    ("embedding", ("vocab", "embed_fsdp")),
    ("lm_head", ("embed_fsdp", "vocab")),
    ("pos_embed", (None, None)),
    ("meta_tokens", (None, None)),
    ("wq_a", ("embed_fsdp", None)),
    ("wq_b", (None, "heads", None)),
    ("wkv_a", ("embed_fsdp", None)),
    ("wkv_b", (None, "heads", None)),
    ("wq", ("embed_fsdp", "heads", None)),
    ("wk", ("embed_fsdp", "kv_heads", None)),
    ("wv", ("embed_fsdp", "kv_heads", None)),
    ("wo", ("heads", None, "embed_fsdp")),
    ("router", ("embed_fsdp", None)),
    ("shared/w1", ("embed_fsdp", "mlp")),
    ("shared/w3", ("embed_fsdp", "mlp")),
    ("shared/w2", ("mlp", "embed_fsdp")),
    ("w1", ("embed_fsdp", "mlp")),
    ("w3", ("embed_fsdp", "mlp")),
    ("w2", ("mlp", "embed_fsdp")),
    ("in_proj", ("embed_fsdp", "inner")),
    ("out_proj", ("inner", "embed_fsdp")),
    ("conv_w", (None, "inner")),
    ("conv_b", ("inner",)),
    ("norm_scale", ("inner",)),
]


def _leaf_logical(path: str, shape) -> Tuple[Optional[str], ...]:
    for sub, axes in _RULES:
        if sub in path:
            n = len(shape)
            if len(axes) < n:  # stacked layer/expert leading dims
                return (("layers",) * (n - len(axes))) + tuple(axes)
            if len(axes) > n:
                return tuple(axes[-n:])
            return tuple(axes)
    return (None,) * len(shape)


def _map_paths(fn, tree, prefix=""):
    """``fn(path, leaf)`` over nested dicts, paths as the reference's
    ``tree_map_with_path`` keys print (``g0/attn/wq``)."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def param_pspecs(abstract_tree, mesh, rule_overrides=None):
    """PartitionSpec tree for a param/optimizer tree from logical rules,
    under the rules and mesh of the current ``sharding_rules`` (leaves
    need only a shape: ``meta`` tensors do).

    MoE expert stacks: the leading expert dim maps to "expert"
    (= model axis, EP); layer-stacked dims are replicated.
    ``rule_overrides``: {leaf-path substring: logical axes tuple} — to test
    alternative layouts without editing _RULES.
    """
    rule_overrides = rule_overrides or {}

    def one(pstr, leaf):
        for sub, ax in rule_overrides.items():
            if sub in pstr:
                n = len(leaf.shape)
                ax = tuple(ax)
                ax = (("layers",) * (n - len(ax)) + ax if len(ax) < n
                      else ax[-n:])
                return logical_spec_for_shape(leaf.shape, *ax)
        axes = list(_leaf_logical(pstr, leaf.shape))
        # expert stacks: routed-expert w1/w2/w3 carry [L, E, in, out] — the
        # expert dim takes the model axis (EP); the hidden dim must then be
        # released (it would double-map "model"); FSDP keeps the d_model dim.
        if ("moe" in pstr and "shared" not in pstr
                and pstr.rsplit("/", 1)[-1] in ("w1", "w2", "w3")
                and len(leaf.shape) >= 4):
            exp_axes = tuple(logical_spec("expert"))[0]
            exp_set = ({exp_axes} if isinstance(exp_axes, str)
                       else set(exp_axes or ()))
            # contraction dims may keep FSDP only when it doesn't collide
            # with the axes the expert dim takes (e.g. 2D "expert" EP)
            tail = ["embed_fsdp" if (a == "embed_fsdp"
                                     and "data" not in exp_set) else None
                    for a in axes[2:]]
            axes = [axes[0], "expert"] + tail
        return logical_spec_for_shape(leaf.shape, *axes)

    return _map_paths(one, abstract_tree)


def state_pspecs(abstract_state: AdamWState, params_specs) -> AdamWState:
    return AdamWState(step=P(), m=params_specs, v=params_specs)


def batch_pspec():
    return logical_spec("batch")
