"""Neural graph construction for the Llama3 case study (paper §4).

Builds the inference computational graph the compiler consumes — prefill
(full prompt, builds KV caches) and decode (single token against cached
K/V, §3.4) — and converts model weights into the chunked relational tables
of Appendix A:

    vocabulary  (token_encode, chunk_id, embedding FLOAT[])
    freq_each_token (token_id, freq_real FLOAT[], freq_img FLOAT[])
    {Q,K,V}_weights_L{i} (head_id, row_id, chunk_id, chunk FLOAT[])
    o_weights_L{i} / GLU_W{1,2,3}_L{i} (row_id, chunk_id, chunk FLOAT[])
    {FFN,Attention}_Norm_L{i} / Final_Norm (chunk_id, chunk FLOAT[])
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import relational as ra
from repro_torch.core.chunked import ChunkedTensor, resolve_device
from repro_torch.core.executor import (DenseTable, permute_table_keys,
                                       scalar_table, table_from_chunked)
from repro_torch.core.graph import Graph
from repro_torch.core.opmap import CACHE_KEY_ORDERS


@dataclasses.dataclass
class LlamaSpec:
    """Minimal Llama-family architecture spec for the relational path."""

    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv: int
    d_ff: int
    rope_theta: float = 500000.0
    eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def build_prefill_graph(spec: LlamaSpec, seq_len: int,
                        cache_len: Optional[int] = None,
                        suffix: bool = False) -> Graph:
    """Prompt-processing graph: causal self-attention over the full prompt,
    writing each layer's K/V into cache tables for subsequent decode.

    ``suffix=True`` builds the *suffix* prefill variant used by the prefix
    cache: the ``seq_len`` new tokens start at runtime position
    ``:cache_position`` over caches already holding that many valid rows
    (a shared prefix segment), so the causal mask admits cached positions
    ``tp <= t + :cache_position`` instead of the static ``tp <= t``.  The
    cache append already rides ``:cache_position``, so one compiled suffix
    plan per suffix length serves every prefix boundary."""
    return _build_graph(spec, new_tokens=seq_len,
                        cache_len=cache_len or seq_len, is_prefill=True,
                        suffix=suffix)


def build_decode_graph(spec: LlamaSpec, cache_len: int,
                       batch: int = 0) -> Graph:
    """Single-token generation graph: new K/V rows appended to the caches
    (INSERT), attention joins the cache tables (paper §3.4).

    ``batch > 0`` builds the *batched* decode graph: a ``seq`` key of that
    size replaces the (length-1) token dim and flows through every
    activation table, the caches gain a leading ``seq`` key, and the
    per-sequence decode positions arrive as the ``seq_positions`` runtime
    vector — one relational plan advances all ``batch`` sequences per
    invocation.  ``batch = 0`` keeps the single-sequence graph bit-identical
    to before."""
    return _build_graph(spec, new_tokens=(batch or 1), cache_len=cache_len,
                        is_prefill=False, batch=batch)


def _build_graph(spec: LlamaSpec, new_tokens: int, cache_len: int,
                 is_prefill: bool, batch: int = 0,
                 suffix: bool = False) -> Graph:
    g = Graph(name=(("llama_prefill_sfx" if suffix else "llama_prefill")
                    if is_prefill
                    else (f"llama_decode_b{batch}" if batch
                          else "llama_decode")))
    T, d, dh = new_tokens, spec.d_model, spec.head_dim
    H, Hkv = spec.n_heads, spec.n_kv
    # batched decode: the token dim *is* the sequence dim — one new token
    # per active sequence, attention joined per sequence against the
    # seq-keyed caches.  INVARIANT the compiler relies on: downstream
    # (graph.infer_shapes attn_scores, opmap.map_attn_scores/attn_output)
    # detects the batched shape by the query's leading key naming the
    # cache's leading key — so the token dim and the cache position dim
    # must keep DISTINCT names in unbatched graphs ("t" vs "tp") and the
    # SAME name ("seq") on both sides in batched ones.
    tok_key = "seq" if batch else "t"

    g.inputs = ["token_ids", "freq_each_token"]
    g.annotate("token_ids", (((tok_key, T)),))
    g.annotate("freq_each_token", ((tok_key, T), ("f", dh)))
    g.annotate("vocabulary", (("tok", spec.vocab), ("d", d)))
    g.initializers["vocabulary"] = None

    x = g.add("embedding", ["vocabulary", "token_ids"], output="x_embed")
    g.annotate(x, ((tok_key, T), ("d", d)))

    for L in range(spec.n_layers):
        for w, dims in _layer_weight_dims(spec, L).items():
            g.initializers[w] = None
            g.annotate(w, dims)

        xn = g.add("rmsnorm", [x, f"Attention_Norm_L{L}"], eps=spec.eps)
        q = g.add("linear_heads", [xn, f"Q_weights_L{L}"], n_heads=H,
                  head_dim=dh, head_key="h")
        k = g.add("linear_heads", [xn, f"K_weights_L{L}"], n_heads=Hkv,
                  head_dim=dh, head_key="hk")
        v = g.add("linear_heads", [xn, f"V_weights_L{L}"], n_heads=Hkv,
                  head_dim=dh, head_key="hk")
        q = g.add("rope", [q, "freq_each_token"])
        k = g.add("rope", [k, "freq_each_token"])

        # keys/values become the cache relations: rename t → tp and give
        # the cache columns distinct names so attention joins are unambiguous
        # (batched: the seq key stays seq — the cache adds its own tp key)
        ren = {} if batch else {"t": "tp"}
        k = g.add("rename", [k], mapping=ren, col_rename="kv")
        v = g.add("rename", [v], mapping=ren, col_rename="vv")
        g.inputs += [f"k_cache_L{L}", f"v_cache_L{L}"]
        cache_attrs = dict(cache_len=cache_len, append_key="tp")
        if batch:
            cache_attrs.update(seq_key="seq", offset_name="seq_positions")
        else:
            cache_attrs.update(offset_name="cache_position")
        k = g.add("concat_rows", [f"k_cache_L{L}", k], **cache_attrs)
        v = g.add("concat_rows", [f"v_cache_L{L}", v], **cache_attrs)

        s = g.add("attn_scores", [q, k], n_heads=H, n_kv=Hkv, head_dim=dh)
        if is_prefill and suffix:
            # suffix prefill: the T new tokens sit at absolute positions
            # :cache_position .. :cache_position+T-1, attending to every
            # cached row of the shared prefix plus their own causal window
            s = g.add("causal_mask", [s], offset_name="cache_position")
        elif is_prefill:
            s = g.add("causal_mask", [s], offset=0)
        elif batch:
            # batched decode: sequence s attends to cached positions ≤ its
            # own absolute position, one entry of :seq_positions per seq
            s = g.add("causal_mask", [s], offset_vec_name="seq_positions")
        else:
            # decode: the new token attends to cached positions ≤ its own
            # absolute position, supplied at runtime (:cache_position)
            s = g.add("causal_mask", [s], offset_name="cache_position")
        p = g.add("softmax", [s])
        o = g.add("attn_output", [p, v], n_heads=H, n_kv=Hkv)
        o = g.add("merge_heads", [o])
        o = g.add("linear", [o, f"o_weights_L{L}"], out_features=d)
        x = g.add("add", [x, o], output=f"x_attn_res_L{L}")

        xn = g.add("rmsnorm", [x, f"FFN_Norm_L{L}"], eps=spec.eps)
        h1 = g.add("linear", [xn, f"GLU_W1_L{L}"], out_features=spec.d_ff)
        h1 = g.add("silu", [h1])
        h3 = g.add("linear", [xn, f"GLU_W3_L{L}"], out_features=spec.d_ff)
        hg = g.add("mul", [h1, h3])
        h2 = g.add("linear", [hg, f"GLU_W2_L{L}"], out_features=d)
        x = g.add("add", [x, h2], output=f"x_mlp_res_L{L}")

    g.initializers["Final_Norm"] = None
    g.initializers["lm_head"] = None
    g.annotate("Final_Norm", (("d", d),))
    g.annotate("lm_head", (("j", spec.vocab), ("d", d)))
    xf = g.add("rmsnorm", [x, "Final_Norm"], eps=spec.eps)
    logits = g.add("linear", [xf, "lm_head"], out_features=spec.vocab,
                   output="logits")
    g.outputs = ["logits"]
    return g


def _layer_weight_dims(spec: LlamaSpec, L: int) -> Dict[str, tuple]:
    d, dh, ff = spec.d_model, spec.head_dim, spec.d_ff
    return {
        f"Q_weights_L{L}": (("h", spec.n_heads), ("r", dh), ("d", d)),
        f"K_weights_L{L}": (("hk", spec.n_kv), ("r", dh), ("d", d)),
        f"V_weights_L{L}": (("hk", spec.n_kv), ("r", dh), ("d", d)),
        f"o_weights_L{L}": (("j", d), ("d", d)),
        f"GLU_W1_L{L}": (("j", ff), ("d", d)),
        f"GLU_W2_L{L}": (("j", d), ("f", ff)),
        f"GLU_W3_L{L}": (("j", ff), ("d", d)),
        f"Attention_Norm_L{L}": (("d", d),),
        f"FFN_Norm_L{L}": (("d", d),),
    }


# ---------------------------------------------------------------------------
# Data conversion (§3.1): weights → chunked relational tables
# ---------------------------------------------------------------------------


def init_llama_params(spec: LlamaSpec, seed: int = 0) -> Dict[str, np.ndarray]:
    """Random (deterministic) Llama weights in the conventional dense layout."""
    rng = np.random.default_rng(seed)
    d, dh, ff = spec.d_model, spec.head_dim, spec.d_ff

    def w(*shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[-1])
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    params = {
        "vocabulary": w(spec.vocab, d, scale=0.02),
        "Final_Norm": np.ones(d, np.float32),
        "lm_head": w(spec.vocab, d),
    }
    for L in range(spec.n_layers):
        params[f"Q_weights_L{L}"] = w(spec.n_heads, dh, d)
        params[f"K_weights_L{L}"] = w(spec.n_kv, dh, d)
        params[f"V_weights_L{L}"] = w(spec.n_kv, dh, d)
        params[f"o_weights_L{L}"] = w(d, d)
        params[f"GLU_W1_L{L}"] = w(ff, d)
        params[f"GLU_W2_L{L}"] = w(d, ff)
        params[f"GLU_W3_L{L}"] = w(ff, d)
        params[f"Attention_Norm_L{L}"] = np.ones(d, np.float32)
        params[f"FFN_Norm_L{L}"] = np.ones(d, np.float32)
    return params




def init_llama_tensors(spec: LlamaSpec, seed: int = 0, *, device
                       ) -> Dict[str, torch.Tensor]:
    """Random Llama weights drawn on ``device`` from a seeded
    ``torch.Generator``, at the shapes and scales of
    :func:`init_llama_params` — for full-width models whose numpy draw on
    the host would be too slow.  The values differ from
    ``init_llama_params(spec, seed)``; only the distribution is shared."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    d, dh, ff = spec.d_model, spec.head_dim, spec.d_ff

    def w(*shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[-1])
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).mul_(scale)

    def ones(n):
        return torch.ones(n, dtype=torch.float32, device=device)

    params = {
        "vocabulary": w(spec.vocab, d, scale=0.02),
        "Final_Norm": ones(d),
        "lm_head": w(spec.vocab, d),
    }
    for L in range(spec.n_layers):
        params[f"Q_weights_L{L}"] = w(spec.n_heads, dh, d)
        params[f"K_weights_L{L}"] = w(spec.n_kv, dh, d)
        params[f"V_weights_L{L}"] = w(spec.n_kv, dh, d)
        params[f"o_weights_L{L}"] = w(d, d)
        params[f"GLU_W1_L{L}"] = w(ff, d)
        params[f"GLU_W2_L{L}"] = w(d, ff)
        params[f"GLU_W3_L{L}"] = w(ff, d)
        params[f"Attention_Norm_L{L}"] = ones(d)
        params[f"FFN_Norm_L{L}"] = ones(d)
    return params


def convert_weights(params: Dict[str, object], chunk_size: int = 128,
                    device="cuda") -> Dict[str, DenseTable]:
    """§3.1 data conversion: every weight (numpy array or tensor) → a
    chunked DenseTable on ``device``, keyed per the Appendix-A schemas
    (trailing dim chunked, leading dims as keys).  This is how the JAX
    package's numpy parameters cross into the port."""
    device = resolve_device(device)
    env: Dict[str, DenseTable] = {}
    for name, arr in params.items():
        ct = ChunkedTensor.from_dense(name, arr, chunk_size=min(
            chunk_size, arr.shape[-1]), device=device)
        env[name] = table_from_chunked(ct)
    return env


def copy_cache_slot(batched_env: Dict[str, DenseTable], seq_id: int,
                    session_env: Dict[str, DenseTable]) -> None:
    """Copy a single-sequence environment's KV-cache tables into slot
    ``seq_id`` of a batched (seq-keyed) environment — the slot-fill step
    that moves a prefilled sequence into a batched decode batch.  Key
    orders are aligned by name.  The slot is written in place: the batched
    tables are owned by their pool, and every view handed out of it is a
    gathered copy."""
    for nm, dst in batched_env.items():
        if not nm.startswith(("k_cache_L", "v_cache_L")):
            continue
        src = permute_table_keys(session_env[nm], dst.key_names[1:])
        cn = next(iter(dst.cols))
        dst.cols[cn][seq_id].copy_(src.cols[cn])


def rope_freq_table(positions: np.ndarray, head_dim: int,
                    theta: float = 500000.0, key: str = "t", *,
                    device) -> DenseTable:
    """freq_each_token(token_id, freq_real, freq_img) for given positions,
    computed in float32 on the host (bit-identical to the reference) and
    moved to ``device``.

    ``key="seq"`` keys the table by sequence for the batched decode graph
    (one position per active sequence)."""
    half = head_dim // 2
    inv = 1.0 / (theta ** (np.arange(half, dtype=np.float32) / half))
    ang = np.asarray(positions)[:, None].astype(np.float32) * inv[None, :]
    return DenseTable(
        keys=((key, len(positions)),),
        cols={"fr": torch.from_numpy(np.cos(ang)).to(device),
              "fi": torch.from_numpy(np.sin(ang)).to(device)},
        col_types={"fr": ra.VEC(half), "fi": ra.VEC(half)},
    )


def token_table(ids: np.ndarray, key: str = "t", *, device) -> DenseTable:
    """token_ids(t, s): the token ids as an int64 column on ``device``
    (int64 is the port's one index type)."""
    ids = np.asarray(ids, np.int64).reshape(-1)
    return scalar_table("token_ids", ((key, len(ids)),),
                        torch.from_numpy(ids).to(device))


def empty_cache_tables(spec: LlamaSpec, cache_len: int, chunk_size: int = 128,
                       layout: str = "row_chunk", batch: int = 0, *,
                       device) -> Dict[str, DenseTable]:
    """Preallocated (zeroed) KV cache tables on ``device``.

    ``layout`` picks the physical key order (planner cache layouts):
    ``"row_chunk"`` (seed ``(tp, hk, c)``), ``"head_major"``
    (``(hk, tp, c)``) or ``"pos_major"`` (``(tp, c, hk)``); the payload is
    always ``FLOAT[chunk]`` over head-dim chunks.  ``batch > 0`` prepends a
    ``seq`` key of that size (the batched decode pipeline's seq-keyed
    caches); the layout permutation applies to the trailing three keys.
    """
    dh = spec.head_dim
    cs = min(chunk_size, dh)
    nch = dh // cs
    seed_keys = (("tp", cache_len), ("hk", spec.n_kv), ("c", nch))
    keys = tuple(seed_keys[i] for i in CACHE_KEY_ORDERS[layout])
    if batch:
        keys = (("seq", batch),) + keys
    shape = tuple(s for _, s in keys) + (cs,)
    env = {}
    for L in range(spec.n_layers):
        for nm, cn in ((f"k_cache_L{L}", "kv"), (f"v_cache_L{L}", "vv")):
            env[nm] = DenseTable(
                keys=keys,
                cols={cn: torch.zeros(shape, dtype=torch.float32,
                                      device=device)},
                col_types={cn: ra.VEC(cs)},
            )
    return env
