"""Input specifications for every (architecture × input-shape) cell.

The stand-ins are ``meta`` tensors (shape and dtype, zero allocation), the
counterpart of the reference's ``jax.ShapeDtypeStruct``s, for the step
function of each cell kind:

  train_4k      train_step(params, opt_state, batch)        seq 4096, gb 256
  prefill_32k   prefill(params, tokens, caches[, aux])      seq 32768, gb 32
  decode_32k    decode_step(params, token, caches, pos)     cache 32768, gb 128
  long_500k     decode_step w/ 524288-token state           gb 1 (SSM/hybrid)

Skips (DESIGN.md §4): long_500k only for sub-quadratic archs (mamba2,
hymba).  Modality frontends are stubs: whisper cells add precomputed frame
embeddings, vlm cells add patch embeddings.

``CellSpec.donate`` keeps the reference's donated argument indices as
data.  Eager PyTorch has no donation: the port's prefill and decode write
the caches in place, and its train step updates the parameters and AdamW
state in place, which is what donation buys the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


def cell_supported(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 512k dense decode exempted "
                       "(DESIGN.md §4)")
    return True, ""


def _sds(shape, dtype: str) -> torch.Tensor:
    """A ``meta`` tensor of ``shape`` and ``dtype`` (``"int32"``,
    ``"bfloat16"``, ...)."""
    return torch.empty(tuple(shape), dtype=getattr(torch, dtype),
                       device="meta")


def batch_specs(cfg: ModelConfig, seq_len: int, global_batch: int
                ) -> Dict[str, Any]:
    b = {"tokens": _sds((global_batch, seq_len), "int32"),
         "labels": _sds((global_batch, seq_len), "int32")}
    if cfg.family == "encdec":
        b["frames"] = _sds((global_batch, cfg.n_frames, cfg.d_model),
                           cfg.dtype)
    if cfg.family == "vlm":
        b["images"] = _sds((global_batch, cfg.n_image_tokens, cfg.d_model),
                           cfg.dtype)
    return b


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> Any:
    return tf.init_caches(cfg, batch, max_len, dtype=torch.bfloat16,
                          device="meta")


def aux_cache_specs(cfg: ModelConfig, batch: int) -> Optional[Any]:
    """Cross-attention KV caches (encdec / vlm) as ``meta`` trees."""
    if cfg.family == "encdec":
        n = cfg.n_frames
    elif cfg.family == "vlm":
        n = cfg.n_image_tokens
    else:
        return None
    groups = [g for g in tf.group_plan(cfg) if g.kind != "enc"]
    out = {}
    for g in groups:
        out[g.name] = {
            "k": _sds((g.n_layers, batch, n, cfg.n_kv, cfg.head_dim),
                      cfg.dtype),
            "v": _sds((g.n_layers, batch, n, cfg.n_kv, cfg.head_dim),
                      cfg.dtype),
        }
    return out


def aux_input_spec(cfg: ModelConfig, batch: int):
    if cfg.family == "encdec":
        return _sds((batch, cfg.n_frames, cfg.d_model), cfg.dtype)
    if cfg.family == "vlm":
        return _sds((batch, cfg.n_image_tokens, cfg.d_model), cfg.dtype)
    return None


@dataclasses.dataclass
class CellSpec:
    arch: str
    shape_name: str
    kind: str                      # train | prefill | decode
    step_fn: Any                   # the function to run
    args: Tuple                    # its arguments as meta tensors
    donate: Tuple[int, ...] = ()   # the reference's donations, as data


def build_cell(cfg: ModelConfig, shape_name: str, opt=None) -> CellSpec:
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_loop import make_train_step

    info = SHAPES[shape_name]
    seq, gb = info["seq_len"], info["global_batch"]
    params_abs = tf.abstract_params(cfg)

    if info["kind"] == "train":
        opt = opt or AdamW(state_dtype="bfloat16")
        step = make_train_step(cfg, opt)
        opt_abs = opt.init(params_abs)
        args = (params_abs, opt_abs, batch_specs(cfg, seq, gb))
        return CellSpec(cfg.name, shape_name, "train", step, args,
                        donate=(0, 1))

    if info["kind"] == "prefill":
        caches = cache_specs(cfg, gb, seq)
        aux = aux_input_spec(cfg, gb)

        if aux is not None:
            def step(params, tokens, caches, aux_in):
                return tf.prefill(params, tokens, cfg, caches,
                                  aux_input=aux_in)
            args = (params_abs, _sds((gb, seq), "int32"), caches, aux)
        else:
            def step(params, tokens, caches):
                return tf.prefill(params, tokens, cfg, caches)
            args = (params_abs, _sds((gb, seq), "int32"), caches)
        return CellSpec(cfg.name, shape_name, "prefill", step, args,
                        donate=(2,))

    # decode: one new token against a cache/state of length seq
    caches = cache_specs(cfg, gb, seq)
    auxc = aux_cache_specs(cfg, gb)
    pos = _sds((), "int32")
    if auxc is not None:
        def step(params, token, caches, aux_caches, position):
            return tf.decode_step(params, token, caches, position, cfg,
                                  aux_caches=aux_caches)
        args = (params_abs, _sds((gb, 1), "int32"), caches, auxc, pos)
    else:
        def step(params, token, caches, position):
            return tf.decode_step(params, token, caches, position, cfg)
        args = (params_abs, _sds((gb, 1), "int32"), caches, pos)
    return CellSpec(cfg.name, shape_name, "decode", step, args, donate=(2,))
