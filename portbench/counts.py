"""The work a served window needs, from the model's shapes and the traffic.

Nothing here reads a launch shape or a kernel: the same tokens served
count the same work whichever kernel does it.

- Model FLOPs (``mfu``): each uncached prefill token and each decode
  token counts twice the layers' projection weights; the LM head counts
  once a prefill and once a decode token; attention counts
  ``4 * layers * heads * head_dim`` for every key a query token reads (a
  token at position ``p`` reads ``p + 1``).  Cached prefix tokens count
  nothing.
- Least time of the projections (``k1_roofline``): each of a layer's
  seven projections and the LM head, at the rows the work needs (the live
  sequences of a decode tick, the uncached tokens of a prefill, one row
  for a prefill's LM head), takes at least ``max(2 M N K / flops, 4 (N K +
  M K + M N) / bandwidth)``: float32 operands, each read once, the output
  written once.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

from portbench.model import Shapes

HERE = Path(__file__).resolve().parent


def peaks() -> Dict[str, float]:
    raw = json.loads((HERE / "peaks.json").read_text())
    return {k: v["value"] for k, v in raw.items() if isinstance(v, dict)}


def projection_params(s: Shapes) -> int:
    """Weights of every layer's seven projections (the LM head apart)."""
    return s.layers * sum(n * k for _, n, k in s.layer_matrices())


def attention_flops_per_key(s: Shapes) -> int:
    return 4 * s.layers * s.heads * s.head_dim


def _keys(first: int, end: int) -> int:
    """Keys read by query tokens at positions ``first .. end - 1``."""
    return end * (end + 1) // 2 - first * (first + 1) // 2


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
            + attention_flops_per_key(s) * _keys(cached, context))


def matmul_least_s(m: int, n: int, k: int, pk: Dict[str, float]) -> float:
    return max(2 * m * n * k / pk["f32_flops_per_s"],
               4 * (n * k + m * k + m * n) / pk["hbm_bytes_per_s"])


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
