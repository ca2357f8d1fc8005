"""The Llama architecture: a dense decoder block (RMSNorm, grouped-query
attention with rotary embeddings, a SwiGLU MLP) as the port's
``core/llama_graph.py`` builds it.  DeepSeek-LLM-7B, Mistral-7B and
Llama-3-8B are all this block.

A configuration names its architecture with ``"model"``; the harness
loads ``archs/<model>.py`` and reaches the model only through these
functions:

- ``shapes(cfg)``: the sizes, from the configuration's ``config.json``
  keys;
- ``block_names(s)`` and ``block_spec(s, block)``: the weights' blocks,
  each drawn from the seed by ``model.block_weights``;
- ``build(s, cfg, weights, device)``: the engine and the ``PagedKVConfig``
  of the scheduler's page pool;
- ``counters(engine)``: the architecture's own program counters, taken at
  the window's edges beside the harness's;
- ``decode_flops``, ``prefill_flops``, ``decode_least_s`` and
  ``prefill_least_s``: the work counts the ``mfu`` and ``k1_roofline``
  readers divide by.

Tensor names and layouts are the Llama graph's (``Q_weights_L{i}`` is
``[heads, head_dim, d_model]``, every matrix is ``[out, in]``).

The counts:

- Model FLOPs (``mfu``): each uncached prefill token and each decode
  token counts twice the layers' projection weights; the LM head counts
  once a prefill and once a decode token; attention counts
  ``4 * layers * heads * head_dim`` for every key a query token reads (a
  token at position ``p`` reads ``p + 1``).  Cached prefix tokens count
  nothing.
- Least time of the projections (``k1_roofline``): each of a layer's
  seven projections and the LM head, at the rows the work needs (the live
  sequences of a decode tick, the uncached tokens of a prefill, one row
  for a prefill's LM head), takes at least ``counts.matmul_least_s``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from portbench.counts import keys_read, matmul_least_s


@dataclasses.dataclass(frozen=True)
class Shapes:
    """The sizes of a Llama-shaped decoder, from a ``config.json``."""

    vocab: int
    d: int
    layers: int
    heads: int
    kv_heads: int
    ff: int
    rope_theta: float
    eps: float
    head_dim: int

    def layer_matrices(self) -> List[Tuple[str, int, int]]:
        """``(name, out, in)`` of a layer's seven projections."""
        d, dh = self.d, self.head_dim
        return [("Q_weights", self.heads * dh, d),
                ("K_weights", self.kv_heads * dh, d),
                ("V_weights", self.kv_heads * dh, d),
                ("o_weights", d, self.heads * dh),
                ("GLU_W1", self.ff, d),
                ("GLU_W3", self.ff, d),
                ("GLU_W2", d, self.ff)]


def shapes(cfg: Dict) -> Shapes:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return Shapes(vocab=cfg["vocab_size"], d=d,
                  layers=cfg["num_hidden_layers"], heads=h,
                  kv_heads=cfg.get("num_key_value_heads", h),
                  ff=cfg["intermediate_size"],
                  rope_theta=float(cfg["rope_theta"]),
                  eps=float(cfg["rms_norm_eps"]),
                  head_dim=cfg.get("head_dim") or d // h)


def block_names(s: Shapes) -> List[str]:
    return ["embed"] + [f"layer{i}" for i in range(s.layers)] + ["head"]


def block_spec(s: Shapes, block: str
               ) -> List[Tuple[str, Tuple[int, ...], Optional[float]]]:
    """``(tensor, shape, scale)``; a scale of ``None`` is a norm weight,
    drawn as ``1 + 0.1 * randn``."""
    d, dh = s.d, s.head_dim
    if block == "embed":
        return [("vocabulary", (s.vocab, d), 0.02)]
    if block == "head":
        return [("Final_Norm", (d,), None),
                ("lm_head", (s.vocab, d), 1 / math.sqrt(d))]
    i = int(block[len("layer"):])
    return [(f"Attention_Norm_L{i}", (d,), None),
            (f"Q_weights_L{i}", (s.heads, dh, d), 1 / math.sqrt(d)),
            (f"K_weights_L{i}", (s.kv_heads, dh, d), 1 / math.sqrt(d)),
            (f"V_weights_L{i}", (s.kv_heads, dh, d), 1 / math.sqrt(d)),
            (f"o_weights_L{i}", (d, s.heads * dh), 1 / math.sqrt(s.heads * dh)),
            (f"FFN_Norm_L{i}", (d,), None),
            (f"GLU_W1_L{i}", (s.ff, d), 1 / math.sqrt(d)),
            (f"GLU_W3_L{i}", (s.ff, d), 1 / math.sqrt(d)),
            (f"GLU_W2_L{i}", (d, s.ff), 1 / math.sqrt(s.ff))]


def build(s: Shapes, cfg: Dict, weights, device):
    """``RelationalEngine`` over the Llama graph, with the knobs of the
    configuration's ``engine`` block, and the ``PagedKVConfig`` of a page
    pool with room for every slot at the longest context."""
    from repro_torch.core.llama_graph import LlamaSpec
    from repro_torch.serving.engine import RelationalEngine
    from repro_torch.serving.kvcache import PagedKVConfig

    e = cfg["engine"]
    max_len = cfg["max_position_embeddings"]
    spec = LlamaSpec(vocab=s.vocab, d_model=s.d, n_layers=s.layers,
                     n_heads=s.heads, n_kv=s.kv_heads, d_ff=s.ff,
                     rope_theta=s.rope_theta, eps=s.eps)
    knobs = dict(chunk_size=e["chunk_size"], max_len=max_len,
                 row2col=e["row2col"], cache_layout=e["cache_layout"],
                 precision=e["precision"], device=device)
    if e["residency"] == "paged":
        knobs.update(residency="paged", budget_bytes=e["budget_bytes"],
                     pager_policy=e["pager_policy"])
    engine = RelationalEngine(spec, weights, **knobs)
    page = e["kv_page_tokens"]
    per_seq = -(-max_len // page) + 1
    kv = PagedKVConfig(n_layers=s.layers, n_kv=s.kv_heads,
                       head_dim=s.head_dim, page_size=page,
                       n_pages=e["slots"] * per_seq,
                       max_pages_per_seq=per_seq)
    return engine, kv


def counters(engine) -> Dict[str, int]:
    """The dense block counts nothing beyond the harness's counters."""
    return {}


def projection_params(s: Shapes) -> int:
    """Weights of every layer's seven projections (the LM head apart)."""
    return s.layers * sum(n * k for _, n, k in s.layer_matrices())


def attention_flops_per_key(s: Shapes) -> int:
    return 4 * s.layers * s.heads * s.head_dim


def decode_flops(s: Shapes, rows: int, keys: int) -> float:
    """A decode tick of ``rows`` live sequences reading ``keys`` keys in
    all (the sum of their positions plus one)."""
    return (rows * (2 * projection_params(s) + 2 * s.vocab * s.d)
            + attention_flops_per_key(s) * keys)


def prefill_flops(s: Shapes, context: int, cached: int) -> float:
    """A prefill of ``context`` tokens of which ``cached`` came from the
    prefix cache."""
    new = context - cached
    return (new * 2 * projection_params(s) + 2 * s.vocab * s.d
            + attention_flops_per_key(s) * keys_read(cached, context))


def projections_least_s(s: Shapes, rows: int, head_rows: int,
                        pk: Dict[str, float]) -> float:
    layer = sum(matmul_least_s(rows, n, k, pk)
                for _, n, k in s.layer_matrices())
    return s.layers * layer + matmul_least_s(head_rows, s.vocab, s.d, pk)


def decode_least_s(s: Shapes, rows: int, pk: Dict[str, float]) -> float:
    return projections_least_s(s, rows, rows, pk)


def prefill_least_s(s: Shapes, context: int, cached: int,
                    pk: Dict[str, float]) -> float:
    return projections_least_s(s, context - cached, 1, pk)
