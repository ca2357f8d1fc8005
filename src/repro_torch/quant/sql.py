"""SQL rendering for quantised chunk tables (both dialects).

Three artefacts per quantised table:

* **DDL** — the quantised twin's schema: same INT32 keys, the payload as an
  integer-code array column plus one FLOAT scale per chunk group
  (``qchunk TINYINT[cs], scale FLOAT`` for int8; ``UTINYINT`` codes for
  NF4).
* **Conversion SQL** — ``CREATE OR REPLACE TABLE W__int8 AS SELECT …
  FROM W`` quantising a *stored f32* chunk table in place of the §3.1 data
  conversion (runs after the f32 load, and after the ROW2COL conversion
  when the source is a column table).
* **UDF prelude** — ``absmax`` / ``nf4_encode`` / ``nf4_dequant`` macros.
  The encode macro counts the same ``>``-against-midpoint comparisons the
  codecs' quantise uses, so SQL and executor produce identical codes.

The dequant *projection* itself is ordinary relational IR
(``Codec.dequant_expr``) rendered by ``core/sqlgen`` — it needs no special
casing beyond the ``nf4_dequant`` intrinsic.
"""

from __future__ import annotations

from typing import List

from repro_torch.quant.codecs import CODECS, NF4_LEVELS, NF4_MIDPOINTS, SCALE_EPS


def _nf4_levels_literal() -> str:
    return "[" + ", ".join(f"{v!r}" for v in NF4_LEVELS) + "]"


def _nf4_encode_body() -> str:
    """Sum of 15 midpoint comparisons == index of the nearest NF4 level
    (ties above a midpoint round up, exactly like ``Codec.quantise``)."""
    terms = [f"(CASE WHEN v > {m!r} THEN 1 ELSE 0 END)"
             for m in NF4_MIDPOINTS]
    return " + ".join(terms)


UDF_PRELUDE_QUANT_DUCKDB = f"""\
-- Quantised chunk-payload macros (INT8 absmax / NF4 block codecs)
CREATE OR REPLACE MACRO absmax(arr) AS
  (list_aggregate(list_transform(arr, x -> abs(x)), 'max'));
CREATE OR REPLACE MACRO nf4_dequant(arr) AS
  (list_transform(arr, x ->
     list_extract({_nf4_levels_literal()}, CAST(x AS INTEGER) + 1)));
CREATE OR REPLACE MACRO nf4_encode(v) AS
  (CAST({_nf4_encode_body()} AS UTINYINT));
"""


def quant_ddl(name: str, schema, codec_name: str,
              q_col: str = "qchunk", scale_col: str = "scale") -> str:
    """CREATE TABLE for a quantised chunk table (dialect-invariant, like
    the f32 DDL — the payload dtype is the codec's integer code type)."""
    from repro_torch.core.relational import is_vec, vec_width
    codec = CODECS[codec_name]
    cols = [f"{k} INT32" for k in schema.key_names]
    for c, t in schema.cols:
        if c == q_col:
            cols.append(f"{c} {codec.sql_code_type}[{vec_width(t)}]")
        elif is_vec(t):
            cols.append(f"{c} FLOAT[{vec_width(t)}]")
        else:
            cols.append(f"{c} FLOAT")
    return f"CREATE TABLE {name} ({', '.join(cols)});"


def quantise_conversion_sql(table: str, q_table: str, codec_name: str,
                            key_names, vec_col: str,
                            dialect: str = "duckdb") -> str:
    """One table's f32 → quantised conversion statement.

    DuckDB renders the encode as list lambdas over the prelude macros;
    the ansi dialect uses plain ``quantise_int8`` / ``quantise_nf4`` UDF
    names (the same convention as its ``map_vec``)."""
    assert dialect in ("duckdb", "ansi")
    codec = CODECS[codec_name]
    keys = ", ".join(key_names)
    if codec_name == "int8":
        scale = f"greatest(absmax({vec_col}), {SCALE_EPS!r}) / 127.0"
        enc_duck = (f"list_transform({vec_col}, "
                    f"x -> CAST(round(x / scale) AS TINYINT))")
    else:
        scale = f"greatest(absmax({vec_col}), {SCALE_EPS!r})"
        enc_duck = f"list_transform({vec_col}, x -> nf4_encode(x / scale))"
    enc = (enc_duck if dialect == "duckdb"
           else f"quantise_{codec_name}({vec_col}, scale)")
    return (f"-- QUANTISE ({codec_name}): {table} -> {q_table}\n"
            f"CREATE OR REPLACE TABLE {q_table} AS\n"
            f"SELECT {keys}, {enc} AS qchunk, scale\n"
            f"FROM (SELECT {keys}, {vec_col}, {scale} AS scale "
            f"FROM {table});")


def quant_conversion_sql(decisions, dialect: str = "duckdb") -> str:
    """Conversion script for a set of planner precision decisions (runs
    after the f32 tables — row and converted column — are populated)."""
    stmts: List[str] = []
    for d in decisions:
        stmts.append(quantise_conversion_sql(
            d.table, d.q_table, d.precision, d.key_names, d.vec_col,
            dialect))
    return "\n\n".join(stmts)
