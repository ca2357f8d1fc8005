"""Quantised chunk payloads — the precision subsystem (ISSUE 5 tentpole).

Per-table payload *precision* is a planner decision alongside layout and
chunk size: a chunked weight table may be stored f32 (the seed), INT8
(absmax per chunk group) or NF4 (4-bit NormalFloat block codes), with the
matmul projection dequantising inline — pure SQL end to end, in the spirit
of TranSQL+'s dequantise-in-the-projection framing.

  ``quant.codecs``  the codec registry: INT8 / NF4 quantise & dequantise
                    plain PyTorch functions, error bounds, cold-store
                    packing (NF4 packs two codes per byte), the byte
                    model (``precision_bytes``), and the relational
                    encoding (``quant_schema`` + ``Codec.dequant_expr``).
  ``quant.sql``     quantised DDL, the f32 → quantised conversion SQL
                    (both dialects) and the ``absmax`` / ``nf4_encode`` /
                    ``nf4_dequant`` UDF prelude.
  ``quant.gate``    the accuracy-budget gate: quantised logits vs the f32
                    engine under a configurable tolerance.

Integration points: ``planner.plan_layouts(precision_mode=...)`` prices
(layout, chunk_size, precision) triples and rewrites weight Scans into
dequant projections; ``serving.engine.RelationalEngine(precision=...)``
is the user-facing knob (per-table overrides via ``table_precisions``,
gate via ``accuracy_budget``); ``WeightPager``/``LazyEnv`` page the packed
integer payloads, multiplying the effective working-set budget.
"""

from repro_torch.quant.codecs import (CODECS, Codec, NF4_LEVELS, NF4_MIDPOINTS,
                                PRECISIONS, nf4_dequant_levels,
                                precision_bytes, q_table_name, quant_schema,
                                quantise_chunked_table, quantise_dense)
from repro_torch.quant.gate import (AccuracyBudgetExceeded, DEFAULT_TOLERANCES,
                              check_accuracy, logit_error_between,
                              max_logit_error)
from repro_torch.quant.sql import (UDF_PRELUDE_QUANT_DUCKDB, quant_conversion_sql,
                             quant_ddl, quantise_conversion_sql)

__all__ = [
    "AccuracyBudgetExceeded", "CODECS", "Codec", "DEFAULT_TOLERANCES",
    "NF4_LEVELS", "NF4_MIDPOINTS", "PRECISIONS",
    "UDF_PRELUDE_QUANT_DUCKDB", "check_accuracy", "logit_error_between",
    "max_logit_error", "nf4_dequant_levels", "precision_bytes",
    "q_table_name", "quant_conversion_sql", "quant_ddl", "quant_schema",
    "quantise_chunked_table", "quantise_conversion_sql", "quantise_dense",
]
