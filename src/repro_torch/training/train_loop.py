"""Training step: loss, gradients, optimizer update, on one device.

``make_train_step`` builds ``train_step(params, opt_state, batch)``.
Gradients come from ``torch.autograd.grad`` over the parameter leaves in
JAX's order, as a tree like ``jax.value_and_grad``'s (no ``.grad``
buffers stay alive), in the parameters' dtype; gradient accumulation runs
the microbatches (contiguous slices of the batch) one after another into
f32 accumulators.  The clip and the AdamW update then write into the
gradients, the parameters and the optimizer state in place.

The reference's logical-axis sharding rules (``_RULES``, ``param_pspecs``,
``state_pspecs``, ``batch_pspec``) need a device mesh and come with the
distributed slice.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.training.optimizer import (AdamW, AdamWState,
                                            clip_by_global_norm)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       impl: str = "gather") -> torch.Tensor:
    """Token-mean softmax cross entropy in f32.

    impl="gather": the gold logit gathered along the vocab axis.
    impl="onehot": the gold logit as a masked reduction over the vocab
    axis (the reference's choice for a model-sharded vocab axis; one device
    computes the same value).
    """
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
        with torch.enable_grad():
            loss, metrics = loss_fn(tf.tree_unflatten(params, live), mb, cfg)
            grads = torch.autograd.grad(loss, live, allow_unused=True,
                                        materialize_grads=True)
        return list(grads), {k: v.detach() for k, v in metrics.items()}

    def train_step(params, opt_state: AdamWState, batch):
        if grad_accum == 1:
            grads, metrics = single_grads(params, batch)
        else:
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
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
