"""Model assembly: a stacked-layers transformer covering every assigned
architecture family (dense / moe / mla-moe / ssm / hybrid / enc-dec / vlm).

Layers are grouped into homogeneous *groups* (``group_plan``); each group's
parameters are stacked along a leading layer axis, and a group runs as a
Python loop over that axis on views of the stacked parameters and caches
(the reference's ``lax.scan``).  Heterogeneous stacks (deepseek
dense-prefix, vlm cross-attn interleave) become several groups.  Per-layer
scalars that vary inside a group (hymba's sliding-window schedule) ride
along as a per-layer list of host ints instead of splitting the group.

Caches are written in place (the reference donates them to ``jit``):
``prefill`` and ``decode_step`` return the cache tree they were given.
Where a gradient is being taken, ``cfg.remat == "full"`` runs each layer
under ``torch.utils.checkpoint`` (non-reentrant): the backward recomputes
the layer from its input, as the reference's ``jax.checkpoint`` does.
Inference ignores ``remat``; ``scan_unroll`` changes nothing.

API:
    init_params(cfg, seed_or_generator, device)    concrete params
    abstract_params(cfg)                           shapes and dtypes (meta)
    tree_from_numpy(tree, device)                  the reference's weights
    forward(params, batch, cfg)                    logits (training path)
    prefill(params, tokens, cfg, caches, aux)      logits, caches, aux caches
    decode_step(params, token, caches, pos, cfg)   logits, caches
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.chunked import resolve_device
from repro_torch.distributed.sharding import gather_fsdp, shard
from repro_torch.models import attention as att
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (
    DTYPES, dense_init, embed_apply, embed_init, mlp_apply, mlp_init, normal,
    norm_apply, norm_init, rope_table, sinusoidal_positions, unembed_apply,
)

# ---------------------------------------------------------------------------
# Trees: nested dicts of tensors
# ---------------------------------------------------------------------------


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of nested dicts, depth first in sorted-key order (JAX's
    ``tree_leaves`` order: a sum over the leaves, or a checkpoint's key
    order, follows the reference's)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    else:
        yield tree


def tree_unflatten(like, leaves):
    """Nested dicts of ``like``'s structure holding ``leaves``, given in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(like)


def _stack(trees: List[Dict]) -> Dict:
    return tree_map(lambda *ls: torch.stack(ls), *trees)


def _unbind(tree, n: int) -> List:
    """The ``n`` layers of a stacked tree, as views (None gives None a
    layer).  One ``unbind`` a leaf: its backward is one ``stack``, where
    indexing each layer would add a full-size zero gradient a layer."""
    if tree is None:
        return [None] * n
    if isinstance(tree, list):  # per-layer host values
        return tree
    layers = tree_map(lambda a: torch.unbind(a, 0), tree)
    return [tree_map(lambda ls: ls[i], layers) for i in range(n)]


def tree_from_numpy(tree, device="cuda"):
    """The reference's parameter tree after ``np.asarray`` (nested dicts of
    numpy arrays, bfloat16 included) → the port's tree on ``device``."""
    device = resolve_device(device)

    def leaf(a):
        a = np.array(a)  # a writable copy (the reference's are read-only)
        if a.dtype.name == "bfloat16":  # numpy has no bfloat16 of its own
            return torch.from_numpy(a.view(np.int16)).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(a).to(device)
    return tree_map(leaf, tree)


# ---------------------------------------------------------------------------
# Group plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Group:
    name: str
    kind: str       # dense | moe | mla_dense | mla_moe | ssm | hybrid |
                    # enc | encdec_dec | vlm_group
    n_layers: int   # stacked length
    inner: int = 1  # vlm_group: self-attn layers per cross-attn layer


def group_plan(cfg: ModelConfig) -> List[Group]:
    f = cfg.family
    if f == "dense":
        return [Group("g0", "dense", cfg.n_layers)]
    if f == "moe":
        if cfg.mla:
            gs = []
            if cfg.first_dense_layers:
                gs.append(Group("g0", "mla_dense", cfg.first_dense_layers))
            gs.append(Group("g1", "mla_moe",
                            cfg.n_layers - cfg.first_dense_layers))
            return gs
        return [Group("g0", "moe", cfg.n_layers)]
    if f == "ssm":
        return [Group("g0", "ssm", cfg.n_layers)]
    if f == "hybrid":
        return [Group("g0", "hybrid", cfg.n_layers)]
    if f == "encdec":
        return [Group("enc", "enc", cfg.n_enc_layers),
                Group("dec", "encdec_dec", cfg.n_layers)]
    if f == "vlm":
        k = cfg.cross_attn_every
        if cfg.n_layers % k:
            raise ValueError(f"vlm: n_layers {cfg.n_layers} is not a "
                             f"multiple of cross_attn_every {k}")
        return [Group("g0", "vlm_group", cfg.n_layers // k, inner=k - 1)]
    raise ValueError(f"unknown family {f}")


# ---------------------------------------------------------------------------
# Per-layer block init / apply
# ---------------------------------------------------------------------------


def _attn_for(cfg: ModelConfig, gen, cross=False, *, device):
    if cfg.mla and not cross:
        return att.mla_init(gen, cfg, device=device)
    return att.attn_init(gen, cfg, cross=cross, device=device)


def block_init(kind: str, gen, cfg: ModelConfig, *, device) -> Dict:
    p: Dict[str, Any] = {}
    if kind in ("dense", "moe", "mla_dense", "mla_moe", "hybrid", "enc",
                "encdec_dec"):
        p["ln1"] = norm_init(cfg, device=device)
        p["attn"] = _attn_for(cfg, gen, device=device)
        p["ln2"] = norm_init(cfg, device=device)
    if kind == "dense" or kind == "enc":
        p["mlp"] = mlp_init(gen, cfg, device=device)
    elif kind == "mla_dense":
        p["mlp"] = mlp_init(gen, cfg, d_ff=cfg.dense_d_ff or cfg.d_ff,
                            device=device)
    elif kind in ("moe", "mla_moe"):
        p["moe"] = moe_lib.moe_init(gen, cfg, device=device)
    elif kind == "hybrid":
        p["ssm"] = ssm_lib.ssm_init(gen, cfg, device=device)
        p["ln_ssm"] = norm_init(cfg, device=device)
        p["mlp"] = mlp_init(gen, cfg, device=device)
    elif kind == "encdec_dec":
        p["ln_x"] = norm_init(cfg, device=device)
        p["xattn"] = att.attn_init(gen, cfg, cross=False, device=device)
        p["mlp"] = mlp_init(gen, cfg, device=device)
    elif kind == "ssm":
        p["ln1"] = norm_init(cfg, device=device)
        p["ssm"] = ssm_lib.ssm_init(gen, cfg, device=device)
    elif kind == "vlm_group":
        p["self"] = _stack([block_init("dense", gen, cfg, device=device)
                            for _ in range(cfg.cross_attn_every - 1)])
        p["ln_c1"] = norm_init(cfg, device=device)
        p["cross"] = att.attn_init(gen, cfg, cross=True, device=device)
        p["ln_c2"] = norm_init(cfg, device=device)
        p["cross_mlp"] = mlp_init(gen, cfg, device=device)
        p["cross_gate_mlp"] = torch.zeros((), dtype=DTYPES[cfg.param_dtype],
                                          device=device)
    return p


def _ssm_tail(p_ssm, h, cfg: ModelConfig, like: torch.Tensor):
    """The conv window's last ``ssm_conv - 1`` inputs, stashed for decode
    continuation."""
    xBC = (h @ p_ssm["in_proj"])[..., cfg.d_inner: 2 * cfg.d_inner
                                 + 2 * cfg.ssm_ngroups * cfg.ssm_state]
    return xBC[:, -(cfg.ssm_conv - 1):, :].to(like.dtype)


def block_apply(
    kind: str,
    p: Dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    q_pos: torch.Tensor,
    cache: Optional[Dict] = None,
    cache_pos=None,
    kv_valid=None,
    rope_cs=None,
    window=0,
    causal: bool = True,
    aux: Optional[torch.Tensor] = None,       # encoder output / image tokens
    aux_cache: Optional[Dict] = None,         # cross-attn KV cache
):
    """Returns (x, self cache, cross cache).  Attention caches come back as
    the dicts given, written in place; SSM states as new tensors."""
    new_cache, new_aux_cache = cache, aux_cache

    if kind == "ssm":
        h = norm_apply(p["ln1"], x, cfg)
        if cache is not None and x.shape[1] == 1:
            y, new_cache = ssm_lib.ssm_decode_step(p["ssm"], h, cache, cfg)
        else:
            y, final = ssm_lib.ssm_apply(p["ssm"], h, cfg)
            if cache is not None:
                new_cache = {"ssm": final,
                             "conv": _ssm_tail(p["ssm"], h, cfg,
                                               cache["conv"])}
        return x + y, new_cache, new_aux_cache

    if kind == "hybrid":
        h = norm_apply(p["ln1"], x, cfg)
        if cfg.mla:
            a, new_attn = att.mla_apply(p["attn"], h, cfg, q_pos=q_pos,
                                        cache=(cache or {}).get("attn"),
                                        cache_pos=cache_pos,
                                        kv_valid=kv_valid)
        else:
            a, new_attn = att.attn_apply(
                p["attn"], h, cfg, q_pos=q_pos,
                cache=(cache or {}).get("attn"), cache_pos=cache_pos,
                kv_valid=kv_valid, causal=causal, window=window,
                rope_cs=rope_cs)
        sc = (cache or {}).get("ssm")
        if sc is not None and x.shape[1] == 1:
            s, new_ssm = ssm_lib.ssm_decode_step(p["ssm"], h, sc, cfg)
        else:
            s, final = ssm_lib.ssm_apply(p["ssm"], h, cfg)
            new_ssm = None
            if sc is not None:
                new_ssm = {"ssm": final,
                           "conv": _ssm_tail(p["ssm"], h, cfg, sc["conv"])}
        # hymba: mean-fuse the two heads' outputs after per-branch norm
        s = shard(s, "batch", "seq", None)  # reduced before the norm
        y = 0.5 * (a + norm_apply(p["ln_ssm"], s, cfg))
        x = shard(x + y, "batch", "seq", None)
        h2 = norm_apply(p["ln2"], x, cfg)
        x = x + mlp_apply(p["mlp"], h2, cfg)
        new_cache = None
        if cache is not None:
            new_cache = {"attn": new_attn, "ssm": new_ssm}
        return x, new_cache, new_aux_cache

    # attention-based blocks
    h = norm_apply(p["ln1"], x, cfg)
    if cfg.mla and kind in ("mla_dense", "mla_moe"):
        a, new_cache = att.mla_apply(p["attn"], h, cfg, q_pos=q_pos,
                                     cache=cache, cache_pos=cache_pos,
                                     kv_valid=kv_valid)
    else:
        a, new_cache = att.attn_apply(p["attn"], h, cfg, q_pos=q_pos,
                                      cache=cache, cache_pos=cache_pos,
                                      kv_valid=kv_valid, causal=causal,
                                      window=window, rope_cs=rope_cs)
    # the residual stream laid out as between layers: on a mesh, a pending
    # partial sum (the output projection's) is reduced here, where DTensor
    # would otherwise reduce-scatter it over the sequence for the norm
    x = shard(x + a, "batch", "seq", None)

    if kind == "encdec_dec":
        h = norm_apply(p["ln_x"], x, cfg)
        c, new_aux_cache = _cross_from_cache(p["xattn"], h, cfg, q_pos,
                                             aux, aux_cache)
        x = shard(x + c, "batch", "seq", None)

    h = norm_apply(p["ln2"], x, cfg)
    if kind in ("moe", "mla_moe"):
        moe_fn = (moe_lib.moe_apply_ep_local if cfg.moe_impl == "ep_local"
                  else moe_lib.moe_apply)
        x = x + moe_fn(p["moe"], h, cfg)
    else:
        x = x + mlp_apply(p["mlp"], h, cfg)
    return x, new_cache, new_aux_cache


def _cross_from_cache(pa, h, cfg, q_pos, aux, aux_cache):
    """Cross-attention where encoder/image K/V are computed once and cached."""
    if aux_cache is not None and aux is None:
        # decode: reuse cached cross K/V
        T = h.shape[1]
        q = torch.einsum("btd,dhk->bthk", h, pa["wq"])
        if cfg.qk_norm:
            q = att.vec_norm_apply(pa.get("q_norm"), q, cfg.eps)
        k, v = aux_cache["k"], aux_cache["v"]
        mask = torch.zeros((T, k.shape[1]), dtype=torch.float32,
                           device=h.device)
        out = att._sdpa(q, k, v, mask, k.shape[2])
        y = att._out_proj(out, pa["wo"])
        if "gate" in pa:
            y = torch.tanh(pa["gate"]) * y
        return y, aux_cache
    y, _ = att.attn_apply(pa, h, cfg, q_pos=q_pos, kv_x=aux, causal=False)
    k = torch.einsum("btd,dhk->bthk", aux, pa["wk"])
    v = torch.einsum("btd,dhk->bthk", aux, pa["wv"])
    if cfg.qk_norm:
        k = att.vec_norm_apply(pa.get("k_norm"), k, cfg.eps)
    return y, {"k": k, "v": v}


def vlm_group_apply(p, x, cfg, *, q_pos, cache=None, cache_pos=None,
                    kv_valid=None, rope_cs=None, aux=None, aux_cache=None):
    """One vlm super-block: (cross_attn_every - 1) self layers + 1 cross.
    The self layers' caches (``cache["self"]``, stacked) are written in
    place."""
    inner = cfg.cross_attn_every - 1
    caches = _unbind(None if cache is None else cache["self"], inner)
    for p_i, cache_i in zip(_unbind(p["self"], inner), caches):
        x, _, _ = block_apply("dense", p_i, x, cfg, q_pos=q_pos,
                              cache=cache_i, cache_pos=cache_pos,
                              kv_valid=kv_valid, rope_cs=rope_cs)
        x = shard(x, "batch", "seq", None)  # as between layers
    h = norm_apply(p["ln_c1"], x, cfg)
    c, new_aux = _cross_from_cache(p["cross"], h, cfg, q_pos, aux, aux_cache)
    x = shard(x + c, "batch", "seq", None)
    h = norm_apply(p["ln_c2"], x, cfg)
    x = x + torch.tanh(p["cross_gate_mlp"]) * mlp_apply(p["cross_mlp"], h,
                                                        cfg)
    return x, cache, new_aux


# ---------------------------------------------------------------------------
# Whole-model init / apply
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed_or_generator=0, device="cuda") -> Dict:
    """Random parameters at the reference's shapes, scales and
    ``param_dtype``, drawn on ``device`` from a ``torch.Generator`` (or a
    seed for one).  The values are the port's own; to hold the port to
    the reference, carry the reference's with :func:`tree_from_numpy`."""
    device = resolve_device(device)
    gen = seed_or_generator
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device="cpu" if device.type == "meta"
                              else device).manual_seed(int(gen))
    pdt = DTYPES[cfg.param_dtype]
    params: Dict[str, Any] = {"embed": embed_init(gen, cfg, device=device)}
    if not cfg.rope and cfg.family != "encdec":
        params["pos_embed"] = (normal(gen, (cfg.max_positions, cfg.d_model),
                                      device=device) * 0.02).to(pdt)
    if cfg.n_meta_tokens:
        params["meta_tokens"] = (normal(gen, (cfg.n_meta_tokens, cfg.d_model),
                                        device=device) * 0.02).to(pdt)
    for g in group_plan(cfg):
        params[g.name] = _stack([block_init(g.kind, gen, cfg, device=device)
                                 for _ in range(g.n_layers)])
    params["final_norm"] = norm_init(cfg, device=device)
    if cfg.family == "encdec":
        params["enc_final_norm"] = norm_init(cfg, device=device)
        params["dec_pos"] = (normal(gen, (cfg.max_positions, cfg.d_model),
                                    device=device) * 0.02).to(pdt)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab, cfg,
                                       device=device)
    return params


def abstract_params(cfg: ModelConfig) -> Dict:
    """The parameter tree's shapes and dtypes, as ``meta`` tensors."""
    return init_params(cfg, 0, device="meta")


def _logits(params, x, cfg) -> torch.Tensor:
    x = norm_apply(params["final_norm"], x, cfg)
    if cfg.tie_embeddings:
        out = unembed_apply(gather_fsdp(params["embed"]), x, cfg)
    else:
        out = x @ gather_fsdp(params["lm_head"])
    return shard(out, "batch", None, "vocab")


def _window_schedule(cfg: ModelConfig) -> List[int]:
    """Per-layer sliding-window sizes (0 = global) for hybrid models, as
    host ints (a layer reads its entry as an int)."""
    w = [cfg.sliding_window] * cfg.n_layers
    for i in cfg.global_attn_layers:
        w[i] = 0
    return w


def _write_back(view, new) -> None:
    """Copy a layer's new cache leaves into its views of the stacked cache;
    a leaf written in place (the same tensor) is left alone."""
    if isinstance(view, dict):
        for k, v in view.items():
            _write_back(v, new[k])
    elif new is not view:
        view.copy_(new)


def _scan_group(g: Group, gp, x, cfg, apply_one, caches=None, extras=None):
    """Run a stacked group layer by layer.  ``apply_one(p_layer, x,
    cache_layer, extra_layer) -> (x, new_cache_layer, aux_layer)``: the new
    cache goes back into ``caches`` in place; the aux outputs (cross K/V),
    if any, come back stacked.  Returns (x, caches, stacked aux or None).
    Under ``cfg.remat == "full"``, where a gradient is being taken, each
    layer is checkpointed: its backward recomputes it.  Under an FSDP mesh
    a layer's weights are gathered at its use (``gather_fsdp``), inside
    the checkpoint; the residual stream is laid out as ("batch", "seq")
    after every layer.  A cache DTensor sharded on its layer dim (layers
    on different ranks) is gathered whole for the loop and written back
    into its shards after it."""
    n = g.n_layers
    stacked = caches
    if caches is not None:
        caches = tree_map(_layers_gathered, caches)

    def gathered(p_l, *rest):
        return apply_one(gather_fsdp(p_l), *rest)
    body = gathered
    if (cfg.remat == "full" and torch.is_grad_enabled()
            and (x.requires_grad
                 or any(t.requires_grad for t in tree_leaves(gp)))):
        def body(*args):
            return checkpoint(gathered, *args, use_reentrant=False)
    auxes = []
    for p_l, cache_l, extra_l in zip(_unbind(gp, n), _unbind(caches, n),
                                     _unbind(extras, n)):
        x, new_c, aux_l = body(p_l, x, cache_l, extra_l)
        # residual-stream constraint: no-op by default; mapping "seq" to a
        # mesh axis turns the per-layer all-reduces into reduce-scatter /
        # all-gather pairs (Megatron-style sequence parallelism)
        x = shard(x, "batch", "seq", None)
        if caches is not None:
            _write_back(cache_l, new_c)
        auxes.append(aux_l)
    if caches is not None:
        _write_back(stacked, caches)
    aux = _stack(auxes) if auxes and auxes[0] is not None else None
    return x, stacked, aux


def _layers_gathered(t: torch.Tensor) -> torch.Tensor:
    """A DTensor sharded on dim 0 (the stacked layers) replicated on that
    dim's mesh axes; any other tensor as it is."""
    if not isinstance(t, DTensor) or not any(
            p.is_shard(0) for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if p.is_shard(0) else p for p in t.placements])


def _encode(params, frames, cfg: ModelConfig) -> torch.Tensor:
    """Whisper encoder over stub frame embeddings [B, n_frames, d]."""
    x = frames + sinusoidal_positions(frames.shape[1], cfg.d_model,
                                      device=frames.device).to(frames.dtype)
    g = [gr for gr in group_plan(cfg) if gr.name == "enc"][0]
    pos = torch.arange(frames.shape[1], device=frames.device)

    def one(p_l, x, cache_l, extra_l):
        x, _, _ = block_apply("enc", p_l, x, cfg, q_pos=pos, causal=False)
        return x, None, None

    x, _, _ = _scan_group(g, params["enc"], x, cfg, one)
    return norm_apply(params["enc_final_norm"], x, cfg)


def _with_meta(params, x, cfg: ModelConfig):
    if not cfg.n_meta_tokens:
        return x
    B = x.shape[0]
    meta = params["meta_tokens"].expand(B, cfg.n_meta_tokens,
                                        cfg.d_model).to(x.dtype)
    return torch.cat([meta, x], dim=1)


def _rope(cfg, positions):
    if cfg.rope and not cfg.attention_free and not cfg.mla:
        return rope_table(positions, cfg.head_dim, cfg.rope_theta)
    return None


def forward(params: Dict, batch: Dict[str, torch.Tensor], cfg: ModelConfig
            ) -> torch.Tensor:
    """Training/eval forward over full sequences. batch: tokens [B,T]
    (+ frames / images for encdec & vlm). Returns logits [B, T, V]."""
    tokens = batch["tokens"]
    dev = tokens.device
    T = tokens.shape[1] + cfg.n_meta_tokens
    pos = torch.arange(T, device=dev)
    x = embed_apply(gather_fsdp(params["embed"]), tokens, cfg).to(
        DTYPES[cfg.dtype])
    x = _with_meta(params, shard(x, "batch", "seq", None), cfg)
    if not cfg.rope and "pos_embed" in params:
        x = x + params["pos_embed"][:T][None].to(x.dtype)
    if cfg.family == "encdec":
        x = x + params["dec_pos"][:T][None].to(x.dtype)
    rope_cs = _rope(cfg, pos[None])

    aux = None
    if cfg.family == "encdec":
        aux = _encode(params, batch["frames"].to(x.dtype), cfg)
    elif cfg.family == "vlm":
        aux = batch["images"].to(x.dtype)

    windows = _window_schedule(cfg) if cfg.family == "hybrid" else None
    layer_offset = 0
    for g in group_plan(cfg):
        if g.name == "enc":
            continue
        if g.kind == "vlm_group":
            def one(p_l, x, cache_l, extra_l):
                x, _, _ = vlm_group_apply(p_l, x, cfg, q_pos=pos,
                                          rope_cs=rope_cs, aux=aux)
                return x, None, None
        else:
            def one(p_l, x, cache_l, extra_l, kind=g.kind):
                w = extra_l if windows is not None else 0
                x, _, _ = block_apply(kind, p_l, x, cfg, q_pos=pos,
                                      rope_cs=rope_cs, window=w, aux=aux)
                return x, None, None
        extras = None
        if windows is not None:
            extras = windows[layer_offset: layer_offset + g.n_layers]
        x, _, _ = _scan_group(g, params[g.name], x, cfg, one, extras=extras)
        layer_offset += g.n_layers

    if cfg.n_meta_tokens:
        x = x[:, cfg.n_meta_tokens:]
    return _logits(params, x, cfg)


# ---------------------------------------------------------------------------
# Serving: prefill / decode with caches
# ---------------------------------------------------------------------------


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device="cuda") -> Dict:
    """Stacked per-group cache buffers (zeros, each layer its own)."""
    device = resolve_device(device)
    caches: Dict[str, Any] = {}
    eff_len = max_len + cfg.n_meta_tokens

    def stack(n, make):
        return tree_map(lambda l: l.expand((n,) + l.shape).clone(), make())

    def kv():
        return att.empty_cache(cfg, batch, eff_len, dtype, device=device)

    def state():
        return ssm_lib.empty_ssm_state(cfg, batch, dtype, device=device)

    for g in group_plan(cfg):
        if g.kind == "enc":
            continue
        if g.kind == "ssm":
            caches[g.name] = stack(g.n_layers, state)
        elif g.kind == "hybrid":
            caches[g.name] = stack(g.n_layers,
                                   lambda: {"attn": kv(), "ssm": state()})
        elif g.kind == "vlm_group":
            caches[g.name] = stack(
                g.n_layers,
                lambda: {"self": stack(cfg.cross_attn_every - 1, kv)})
        else:
            caches[g.name] = stack(g.n_layers, kv)
    return caches


def prefill(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
            caches: Dict, aux_input: Optional[torch.Tensor] = None):
    """Process the prompt, fill ``caches`` in place.  Returns (last logits,
    caches, aux_caches)."""
    T = tokens.shape[1] + cfg.n_meta_tokens
    pos = torch.arange(T, device=tokens.device)
    x = embed_apply(gather_fsdp(params["embed"]), tokens, cfg).to(
        DTYPES[cfg.dtype])
    x = _with_meta(params, shard(x, "batch", "seq", None), cfg)
    if not cfg.rope and "pos_embed" in params:
        x = x + params["pos_embed"][:T][None].to(x.dtype)
    if cfg.family == "encdec":
        x = x + params["dec_pos"][:T][None].to(x.dtype)
    rope_cs = _rope(cfg, pos[None])

    aux = None
    if cfg.family == "encdec":
        aux = _encode(params, aux_input.to(x.dtype), cfg)
    elif cfg.family == "vlm":
        aux = aux_input.to(x.dtype)

    windows = _window_schedule(cfg) if cfg.family == "hybrid" else None
    valid = T
    aux_caches: Dict[str, Any] = {}
    layer_offset = 0
    for g in group_plan(cfg):
        if g.kind == "enc":
            continue
        if g.kind == "vlm_group":
            def one(p_l, x, cache_l, extra_l):
                return vlm_group_apply(p_l, x, cfg, q_pos=pos, cache_pos=0,
                                       kv_valid=valid, rope_cs=rope_cs,
                                       cache=cache_l, aux=aux)
        elif g.kind == "encdec_dec":
            def one(p_l, x, cache_l, extra_l, kind=g.kind):
                return block_apply(kind, p_l, x, cfg, q_pos=pos,
                                   cache=cache_l, cache_pos=0,
                                   kv_valid=valid, rope_cs=rope_cs, aux=aux)
        else:
            def one(p_l, x, cache_l, extra_l, kind=g.kind):
                w = extra_l if windows is not None else 0
                x, c, _ = block_apply(kind, p_l, x, cfg, q_pos=pos,
                                      cache=cache_l, cache_pos=0,
                                      kv_valid=valid, rope_cs=rope_cs,
                                      window=w)
                return x, c, None
        extras = None
        if windows is not None:
            extras = windows[layer_offset: layer_offset + g.n_layers]
        x, _, aux_c = _scan_group(g, params[g.name], x, cfg, one,
                                  caches=caches[g.name], extras=extras)
        if aux_c is not None:
            aux_caches[g.name] = aux_c
        layer_offset += g.n_layers

    logits = _logits(params, x[:, -1:], cfg)
    return logits, caches, aux_caches


def decode_step(params: Dict, token: torch.Tensor, caches: Dict,
                position, cfg: ModelConfig,
                aux_caches: Optional[Dict] = None):
    """One generation step. token [B,1]; position = absolute index of that
    token (an int; the meta-token offset is applied here).  ``caches`` are
    written in place; returns (logits, caches)."""
    eff_pos = int(position) + cfg.n_meta_tokens
    pos = torch.full((1,), eff_pos, dtype=torch.long, device=token.device)
    x = embed_apply(gather_fsdp(params["embed"]), token, cfg).to(
        DTYPES[cfg.dtype])
    x = shard(x, "batch", "seq", None)
    if not cfg.rope and "pos_embed" in params:
        x = x + params["pos_embed"][pos][None].to(x.dtype)
    if cfg.family == "encdec":
        x = x + params["dec_pos"][pos][None].to(x.dtype)
    rope_cs = _rope(cfg, pos[None])

    windows = _window_schedule(cfg) if cfg.family == "hybrid" else None
    valid = eff_pos + 1
    layer_offset = 0
    for g in group_plan(cfg):
        if g.kind == "enc":
            continue
        extras = None
        if g.kind == "vlm_group":
            extras = aux_caches[g.name]

            def one(p_l, x, cache_l, aux_l):
                x, c, _ = vlm_group_apply(p_l, x, cfg, q_pos=pos,
                                          cache=cache_l, cache_pos=eff_pos,
                                          kv_valid=valid, rope_cs=rope_cs,
                                          aux=None, aux_cache=aux_l)
                return x, c, None
        elif g.kind == "encdec_dec":
            extras = aux_caches[g.name]

            def one(p_l, x, cache_l, aux_l, kind=g.kind):
                x, c, _ = block_apply(kind, p_l, x, cfg, q_pos=pos,
                                      cache=cache_l, cache_pos=eff_pos,
                                      kv_valid=valid, rope_cs=rope_cs,
                                      aux=None, aux_cache=aux_l)
                return x, c, None
        else:
            def one(p_l, x, cache_l, extra_l, kind=g.kind):
                w = extra_l if windows is not None else 0
                x, c, _ = block_apply(kind, p_l, x, cfg, q_pos=pos,
                                      cache=cache_l, cache_pos=eff_pos,
                                      kv_valid=valid, rope_cs=rope_cs,
                                      window=w)
                return x, c, None
            if windows is not None:
                extras = windows[layer_offset: layer_offset + g.n_layers]
        x, _, _ = _scan_group(g, params[g.name], x, cfg, one,
                              caches=caches[g.name], extras=extras)
        layer_offset += g.n_layers

    return _logits(params, x, cfg), caches
