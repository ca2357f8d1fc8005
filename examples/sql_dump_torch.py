"""Emit the complete SQL artifact for a Llama model — the paper's output —
from the PyTorch/CUDA port's compiler (``repro_torch.core``).

    PYTHONPATH=src python examples/sql_dump_torch.py [--out llama.sql] [--full]

Writes a runnable DuckDB script: Appendix-B UDF macros, Appendix-A weight
table DDL, weight INSERTs (sampled unless --full), the prefill views, the
decode views, and the §3.4 KV-cache INSERT statements with the
:cache_position parameter.
"""

import argparse

from repro_torch.core.chunked import ChunkedTensor
from repro_torch.core.graph import infer_shapes
from repro_torch.core.llama_graph import (LlamaSpec, build_decode_graph,
                                          build_prefill_graph,
                                          init_llama_params)
from repro_torch.core.opmap import op_map
from repro_torch.core.passes import postoptimize, preoptimize
from repro_torch.core.sqlgen import generate_sql
from repro_torch.planner import ResidencyPool, union_conversion_sql


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="llama_pipeline.sql")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--chunk-size", type=int, default=64)
    ap.add_argument("--full", action="store_true",
                    help="dump every weight INSERT (large!)")
    ap.add_argument("--row2col", default="off",
                    choices=["off", "auto", "col"],
                    help="physical-layout planner mode (ROW2COL); emits "
                         "column-table DDL + conversion SQL when enabled")
    ap.add_argument("--cache-layout", default="off",
                    choices=["off", "auto", "row_chunk", "head_major",
                             "pos_major"],
                    help="KV-cache physical key order (planner cache "
                         "layouts); annotates the cache DDL")
    ap.add_argument("--precision", default="off",
                    choices=["off", "auto", "int8", "nf4"],
                    help="stored payload precision (quantised chunk "
                         "tables); emits quantised DDL + the f32 -> "
                         "quantised conversion SQL when enabled")
    args = ap.parse_args()

    spec = LlamaSpec(vocab=256, d_model=64, n_layers=2, n_heads=4, n_kv=2,
                     d_ff=128, rope_theta=10000.0)
    params = init_llama_params(spec, seed=0)

    parts = ["-- ============ TranSQL+ compiled pipeline ============"]

    # plan decode first: its cost-chosen cache layout binds the prefill
    # pipeline too (both read/write the same cache tables), and a shared
    # residency pool pins per-table precisions across both plans
    pool = ResidencyPool(None)
    gd = build_decode_graph(spec, cache_len=args.max_len)
    infer_shapes(gd)
    preoptimize(gd)
    pipe_d = op_map(gd, chunk_size=args.chunk_size)
    postoptimize(pipe_d, layout_mode=args.row2col,
                 cache_mode=args.cache_layout, pool=pool,
                 precision_mode=args.precision)
    plan_d = pipe_d.layout_plan
    cache_layout = (plan_d.cache_decisions[0].layout
                    if plan_d is not None and plan_d.cache_decisions
                    else "off")

    gp = build_prefill_graph(spec, args.prompt_len, cache_len=args.max_len)
    infer_shapes(gp)
    preoptimize(gp)
    pipe_p = op_map(gp, chunk_size=args.chunk_size)
    postoptimize(pipe_p, layout_mode=args.row2col, cache_mode=cache_layout,
                 pool=pool, precision_mode=args.precision)
    parts.append("-- ---- prefill pipeline (prompt length "
                 f"{args.prompt_len}) ----")
    # the ROW2COL conversion is emitted after the weight INSERTs below, so
    # the column tables are built from populated row tables
    parts.append(generate_sql(pipe_p, dialect="duckdb", include_ddl=True))

    parts.append("\n-- ---- decode pipeline (:cache_position parameter) ----")
    parts.append(generate_sql(pipe_d, dialect="duckdb", include_ddl=False))

    parts.append("\n-- ---- §3.1 data conversion (weight INSERTs) ----")
    limit = None if args.full else 2
    for name, arr in params.items():
        ct = ChunkedTensor.from_dense(
            name, arr, chunk_size=min(args.chunk_size, arr.shape[-1]),
            device="cpu")
        parts.append(f"-- {name}: {arr.shape}")
        parts.append(ct.insert_sql(limit=limit))
        if limit is not None:
            parts.append(f"-- ... truncated (use --full for all rows)")

    # ROW2COL + quantisation conversions after the data load; prefill and
    # decode pipelines are planned independently, so union their choices
    conv = union_conversion_sql((pipe_p, pipe_d), dialect="duckdb")
    if conv:
        parts.append("\n-- ---- physical-design data conversion (ROW2COL "
                     "column tables, then quantised payloads) ----")
        parts.append(conv)

    parts.append("\n-- ---- final sampling query (greedy) ----")
    parts.append(
        "SELECT c * {cs} + e AS token_id FROM (SELECT c, e, x FROM (\n"
        "  SELECT l.c, u.e, l.v[u.e + 1] AS x FROM logits AS l,\n"
        "  (SELECT UNNEST(range({cs})) AS e) AS u)\n"
        "ORDER BY x DESC LIMIT 1);".format(cs=args.chunk_size))

    sql = "\n".join(parts)
    with open(args.out, "w") as f:
        f.write(sql)
    print(f"wrote {args.out}: {len(sql)} chars, "
          f"{sql.count('CREATE OR REPLACE VIEW')} views, "
          f"{sql.count('INSERT INTO')} inserts")


if __name__ == "__main__":
    main()
