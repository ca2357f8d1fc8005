"""Stage 2 — SQL code generation (§2.3, §3.3).

Turns the relational pipeline into executable SQL for a target dialect.
Each bind step becomes a ``CREATE OR REPLACE VIEW`` (or a WITH-CTE chain for
its interior nodes); KV-cache appends become ``INSERT INTO`` statements
(§3.4).  Vector operations lower to the paper's Appendix-B UDF macros
(``hadamard_prod``, ``element_sum``, ``sumForEach``, ``collect_as_array``,
``view_as_real``) plus the engine's native list functions.

Dialects: ``duckdb`` (list lambdas, ``range()`` table function, 1-based list
slicing — the paper's evaluation engine) and ``ansi`` (plain UDF names, WITH
ORDINALITY unnest) for portability.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

from repro_torch.core.relational import (
    BinOp, Call, Col, Collect, Const, Expr, Filter, GroupAgg, Join, Key,
    KeyParam, Param, Project, RelNode, RelSchema, Scan, Unnest, expr_type,
    is_vec, resolve, vec_width, SCALAR,
)
from repro_torch.core.executor import plan_provenance
from repro_torch.core.opmap import RelPipeline

UDF_PRELUDE_DUCKDB = """\
-- Appendix B vector UDF macros (DuckDB lambda syntax)
CREATE OR REPLACE MACRO hadamard_prod(arr1, arr2) AS
  (list_transform(list_zip(arr1, arr2), x -> x[1] * x[2]));
CREATE OR REPLACE MACRO element_sum(arr1, arr2) AS
  (list_transform(list_zip(arr1, arr2), x -> x[1] + x[2]));
CREATE OR REPLACE MACRO element_neg_sum(arr1, arr2) AS
  (list_transform(list_zip(arr1, arr2), x -> x[1] - x[2]));
CREATE OR REPLACE MACRO element_div(arr1, arr2) AS
  (list_transform(list_zip(arr1, arr2), x -> x[1] / x[2]));
CREATE OR REPLACE MACRO view_as_real(arr1, arr2) AS (list_concat(arr1, arr2));
CREATE OR REPLACE MACRO collect_as_array(idx, val) AS
  (list_transform(list_sort(list_zip(idx, val)), x -> x[2]));
CREATE OR REPLACE MACRO sumForEach(arrs) AS
  (list_reduce(arrs, (acc, row) ->
     list_transform(list_zip(acc, row), p -> p[1] + p[2])));
"""


def _sn(name: str) -> str:
    """Sanitise a tensor name into a SQL identifier."""
    return re.sub(r"[^A-Za-z0-9_]", "_", name)


@dataclasses.dataclass(frozen=True)
class StatementProvenance:
    """What a generated SQL segment *is* in pipeline terms.

    The statement↔op provenance tag the observability layer
    (:mod:`repro_torch.obs`) keys DB profiles by: each emitted script segment
    records the pipeline step it implements, the relational op classes
    in that step's plan, the base tables it scans and — for precision-
    planned pipelines — which of those are quantised (their projections
    are dequantising projections).
    """

    kind: str                            # prelude|comment|ddl|conversion|
    #                                      bind|append
    step: Optional[str] = None           # pipeline step name (bind/append)
    target: Optional[str] = None         # created view/table, INSERT target
    tables: Tuple[str, ...] = ()         # base tables the plan scans
    ops: Tuple[str, ...] = ()            # relational op classes in the plan
    quantised: Tuple[str, ...] = ()      # scanned tables storing quantised
    #                                      payloads (dequant-projection)
    shard: Optional[int] = None          # shard index for per-shard
    #                                      statements (slice conversions and
    #                                      per-shard plan views); None for
    #                                      shard-agnostic segments incl. the
    #                                      combine relation


class SQLGenerator:
    def __init__(self, pipeline: RelPipeline, dialect: str = "duckdb"):
        assert dialect in ("duckdb", "ansi")
        self.p = pipeline
        self.dialect = dialect
        # roots of earlier steps referenced by name
        self.named_roots: Dict[int, str] = {}
        self._cte_counter = 0

    # -- expression rendering -------------------------------------------------

    def _vec_lambda(self, arr: str, body: str) -> str:
        if self.dialect == "duckdb":
            return f"list_transform({arr}, x -> {body})"
        return f"map_vec({arr}, '{body}')"

    def _key_param(self, name: str, key_ref: str) -> str:
        """Per-key list-parameter lookup (1-indexed by the key column)."""
        if self.dialect == "duckdb":
            return f"list_extract(:{name}, {key_ref} + 1)"
        return f":{name}[{key_ref} + 1]"

    def render_expr(self, e: Expr, schema: RelSchema, qual: str = "") -> str:
        q = f"{qual}." if qual else ""

        def rec(e: Expr) -> Tuple[str, bool]:
            if isinstance(e, Col):
                return f"{q}{_sn(e.name)}", is_vec(schema.col_type(e.name))
            if isinstance(e, Key):
                return f"{q}{_sn(e.name)}", False
            if isinstance(e, Const):
                v = e.value
                return (str(int(v)) if float(v).is_integer() and abs(v) < 2**31
                        else f"{v!r}"), False
            if isinstance(e, Param):
                return f":{e.name}", False
            if isinstance(e, KeyParam):
                # per-key parameter vector bound as a list: 1-indexed lookup
                # by the key column (batched decode's :seq_positions)
                return self._key_param(e.name, f"{q}{_sn(e.key)}"), False
            if isinstance(e, BinOp):
                (ls, lv), (rs, rv) = rec(e.lhs), rec(e.rhs)
                if lv and rv:
                    macro = {"*": "hadamard_prod", "+": "element_sum",
                             "-": "element_neg_sum", "/": "element_div"}[e.op]
                    return f"{macro}({ls}, {rs})", True
                if lv != rv:  # vec ⊙ scalar broadcast
                    arr, s = (ls, rs) if lv else (rs, ls)
                    body = (f"x {e.op} ({s})" if lv or e.op in "+*"
                            else f"({s}) {e.op} x")
                    return self._vec_lambda(arr, body), True
                op = {"//": "//" if self.dialect == "duckdb" else "/",
                      "%": "%"}.get(e.op, e.op)
                return f"({ls} {op} {rs})", False
            if isinstance(e, Call):
                args = [rec(a) for a in e.args]
                return self._render_call(e.fn, e.args, args, schema)
            raise TypeError(e)

        return rec(e)[0]

    def _render_call(self, fn: str, raw_args, args: List[Tuple[str, bool]],
                     schema: RelSchema) -> Tuple[str, bool]:
        a0, v0 = args[0]
        if fn == "dot":
            a1, _ = args[1]
            if self.dialect == "duckdb":
                return f"list_dot_product({a0}, {a1})", False
            return f"dot({a0}, {a1})", False
        if fn == "vsum":
            return (f"list_sum({a0})" if self.dialect == "duckdb"
                    else f"vsum({a0})"), False
        if fn == "nf4_dequant":
            # NF4 codebook lookup (quantised chunk payloads): a prelude
            # macro in duckdb, a plain UDF name in ansi
            return f"nf4_dequant({a0})", True
        if fn == "scale":
            a1, _ = args[1]
            if v0:
                return self._vec_lambda(a0, f"x * ({a1})"), True
            return f"({a0} * {a1})", False
        if fn == "concat":
            a1, _ = args[1]
            return f"view_as_real({a0}, {a1})", True
        if fn in ("first_half", "second_half"):
            w = vec_width(expr_type(raw_args[0], schema))
            if fn == "first_half":
                return f"{a0}[1:{w // 2}]", True
            return f"{a0}[{w // 2 + 1}:{w}]", True
        scalar_bodies = {
            "exp": "exp(x)", "neg": "-x", "sqrt": "sqrt(x)",
            "rsqrt": "1.0 / sqrt(x)", "sigmoid": "1.0 / (1.0 + exp(-x))",
            "silu": "x / (1.0 + exp(-x))", "square": "x * x",
            "gelu": "0.5 * x * (1.0 + tanh(0.7978845608 * (x + 0.044715 * x * x * x)))",
            "identity": "x",
        }
        if fn in scalar_bodies:
            body = scalar_bodies[fn]
            if v0:
                return self._vec_lambda(a0, body), True
            return f"({body.replace('x', f'({a0})')})", False
        raise NotImplementedError(f"SQL for intrinsic {fn}")

    # -- node rendering --------------------------------------------------------

    def _ref(self, node: RelNode, ctes: List[Tuple[str, str]]) -> str:
        """Render a node as a FROM-able reference (table, view or CTE)."""
        if id(node) in self.named_roots:
            return self.named_roots[id(node)]
        if isinstance(node, Scan):
            return _sn(node.table)
        self._cte_counter += 1
        name = f"t{self._cte_counter}"
        ctes.append((name, self.render_select(node, ctes)))
        return name

    def render_select(self, node: RelNode, ctes: List[Tuple[str, str]]) -> str:
        s = resolve(node)
        if isinstance(node, Scan):
            return f"SELECT * FROM {_sn(node.table)}"

        if isinstance(node, Project):
            src = self._ref(node.input, ctes)
            in_s = resolve(node.input)
            parts = []
            if node.keys is None:
                parts += [_sn(k) for k in in_s.key_names]
            else:
                for k, _, e in node.keys:
                    parts.append(f"{self.render_expr(e, in_s)} AS {_sn(k)}")
            for (c, _, e), (_, _t) in zip(node.exprs, s.cols):
                parts.append(f"{self.render_expr(e, in_s)} AS {_sn(c)}")
            return f"SELECT {', '.join(parts)} FROM {src}"

        if isinstance(node, Join):
            lsrc = self._ref(node.left, ctes)
            rsrc = self._ref(node.right, ctes)
            ls, rs = resolve(node.left), resolve(node.right)
            conds = []
            for rkey, e in node.on:
                conds.append(
                    f"R.{_sn(rkey)} = {self.render_expr(e, ls, qual='L')}")
            joined = {k for k, _ in node.on}
            parts = [f"L.{_sn(k)}" for k in ls.key_names]
            parts += [f"R.{_sn(k)}" for k in rs.key_names if k not in joined]
            parts += [f"L.{_sn(c)}" for c in ls.col_names]
            lcols = set(ls.col_names)
            for c in rs.col_names:
                alias = c if c not in lcols else c + "_r"
                parts.append(f"R.{_sn(c)} AS {_sn(alias)}")
            return (f"SELECT {', '.join(parts)} FROM {lsrc} AS L "
                    f"JOIN {rsrc} AS R ON {' AND '.join(conds)}")

        if isinstance(node, GroupAgg):
            src = self._ref(node.input, ctes)
            in_s = resolve(node.input)
            keys = [_sn(k) for k in node.group_keys]
            parts = list(keys)
            for out, fn, e in node.aggs:
                body = self.render_expr(e, in_s)
                if is_vec(expr_type(e, in_s)) and fn == "SUM":
                    parts.append(f"sumForEach(LIST({body})) AS {_sn(out)}")
                else:
                    parts.append(f"{fn}({body}) AS {_sn(out)}")
            gb = f" GROUP BY {', '.join(keys)}" if keys else ""
            return f"SELECT {', '.join(parts)} FROM {src}{gb}"

        if isinstance(node, Filter):
            src = self._ref(node.input, ctes)
            in_s = resolve(node.input)
            op, lhs, rhs = node.predicate
            pred = (f"{self.render_expr(lhs, in_s)} {op} "
                    f"{self.render_expr(rhs, in_s)}")
            return f"SELECT * FROM {src} WHERE {pred}"

        if isinstance(node, Unnest):
            src = self._ref(node.input, ctes)
            in_s = resolve(node.input)
            w = vec_width(in_s.col_type(node.vec_col))
            keys = [f"S.{_sn(k)}" for k in in_s.key_names]
            others = [f"S.{_sn(c)}" for c, t in in_s.cols if c != node.vec_col]
            if self.dialect == "duckdb":
                return (f"SELECT {', '.join(keys + others)}, E.{node.elem_key}, "
                        f"S.{_sn(node.vec_col)}[E.{node.elem_key} + 1] AS "
                        f"{node.elem_col} FROM {src} AS S, "
                        f"(SELECT UNNEST(range({w})) AS {node.elem_key}) AS E")
            return (f"SELECT {', '.join(keys + others)}, U.ord - 1 AS "
                    f"{node.elem_key}, U.{node.elem_col} FROM {src} AS S, "
                    f"UNNEST(S.{_sn(node.vec_col)}) WITH ORDINALITY AS "
                    f"U({node.elem_col}, ord)")

        if isinstance(node, Collect):
            src = self._ref(node.input, ctes)
            in_s = resolve(node.input)
            keys = [_sn(k) for k in in_s.key_names if k != node.fold_key]
            parts = list(keys)
            parts.append(
                f"collect_as_array(LIST({_sn(node.fold_key)}), "
                f"LIST({_sn(node.scalar_col)})) AS {_sn(node.vec_col)}")
            gb = f" GROUP BY {', '.join(keys)}" if keys else ""
            return f"SELECT {', '.join(parts)} FROM {src}{gb}"

        raise TypeError(node)

    # -- pipeline rendering ----------------------------------------------------

    def render_step_sql(self, name: str, plan: RelNode,
                        create: str = "VIEW") -> str:
        named = self.named_roots.get(id(plan))
        if named is not None and named != _sn(name):
            # the whole step is an already-materialised relation — e.g. a
            # shard combine over a step that IS a single matmul site
            return (f"CREATE OR REPLACE {create} {_sn(name)} AS\n"
                    f"SELECT * FROM {named};")
        ctes: List[Tuple[str, str]] = []
        body = self.render_select(plan, ctes)
        if ctes:
            with_clause = ",\n  ".join(f"{n} AS ({sql})" for n, sql in ctes)
            body = f"WITH {with_clause}\n{body}"
        return f"CREATE OR REPLACE {create} {_sn(name)} AS\n{body};"

    def generate(self, include_ddl: bool = True,
                 include_conversion: bool = False,
                 step_create: str = "VIEW") -> str:
        """Emit the full SQL script for the pipeline.

        The ROW2COL conversion (``CREATE OR REPLACE TABLE W__col AS
        SELECT ... FROM W``) must run *after* the row tables are populated,
        which this script cannot know about — so it is omitted by default.
        Pass ``include_conversion=True`` for a script targeting an
        already-loaded row-layout database, or emit
        ``LayoutPlan.conversion_sql`` / ``planner.union_conversion_sql``
        after your data-load step (see ``examples/sql_dump.py``).
        """
        return "\n\n".join(
            sql for sql, _ in self.generate_with_provenance(
                include_ddl, include_conversion=include_conversion,
                step_create=step_create))

    def generate_with_provenance(
            self, include_ddl: bool = True,
            include_conversion: bool = False,
            step_create: str = "VIEW",
    ) -> List[Tuple[str, StatementProvenance]]:
        """Emit the script as (segment, provenance-tag) pairs.

        Same segments, same order, same text as :meth:`generate` — the
        script is the ``"\\n\\n"``-join of the first elements.  Each
        segment carries a :class:`StatementProvenance` tag mapping it
        back to the pipeline step / relational ops that generated it, so
        per-operator DB profiles can be attributed (:mod:`repro_torch.obs`).

        ``step_create="TABLE"`` materialises every bind step as a table
        instead of a view: views are lazy (their operators execute — and
        profile — wherever they are *read*), so per-step tracing runs the
        pipeline step by step the way the tensor executor does.
        """
        out: List[Tuple[str, StatementProvenance]] = []

        def emit(sql: str, **prov) -> None:
            out.append((sql, StatementProvenance(**prov)))

        layouts = getattr(self.p, "layouts", {}) or {}
        chunks = getattr(self.p, "table_chunks", {}) or {}
        precisions = getattr(self.p, "table_precisions", {}) or {}
        plan = getattr(self.p, "layout_plan", None)
        shard_plan = getattr(self.p, "shard_plan", None)
        qset = set(precisions)

        def annotate(name: str, ddl: str) -> str:
            # planner annotations: physical layout and (when the chunk
            # size is a planner decision) the per-table chunk size — the
            # DDL's FLOAT[n] width is normative, the comment marks it as
            # planner-chosen rather than the pipeline default
            ann = []
            if name in layouts:
                ann.append(f"layout: {layouts[name]}")
            if name in chunks:
                ann.append(f"chunk_size: {chunks[name]} (planner)")
            if name in precisions:
                ann.append(f"precision: {precisions[name]} (planner)")
            return f"-- {'; '.join(ann)}\n{ddl}" if ann else ddl

        def table_ddl(name: str, schema: RelSchema) -> str:
            if name in precisions:
                from repro_torch.quant.sql import quant_ddl
                return quant_ddl(name, schema, precisions[name])
            return self._ddl(name, schema)

        def step_prov(step, root) -> Dict:
            ops, tables = plan_provenance(root)
            quant = tuple(t for t in tables if t in qset)
            if step.kind == "append":
                ops = tuple(sorted(ops + ("cache_append",)))
            return dict(step=step.name, tables=tables, ops=ops,
                        quantised=quant)

        if include_ddl:
            if self.dialect == "duckdb":
                emit(UDF_PRELUDE_DUCKDB, kind="prelude")
                if precisions:
                    from repro_torch.quant.sql import UDF_PRELUDE_QUANT_DUCKDB
                    emit(UDF_PRELUDE_QUANT_DUCKDB, kind="prelude")
            emit("-- weight table DDL (paper §3.1 data conversion)",
                 kind="comment")
            for name, schema in self.p.weight_schemas.items():
                emit(annotate(name, table_ddl(name, schema)),
                     kind="ddl", target=name,
                     quantised=(name,) if name in qset else ())
            if plan is not None and plan.col_decisions:
                # the rewritten pipeline no longer scans the row-layout
                # sources, but the conversion reads them — keep their DDL
                emit("-- ROW2COL source tables (row_chunk; load "
                     "weights here, then run the conversion)",
                     kind="comment")
                for d in plan.col_decisions:
                    emit(self._ddl(d.table, d.row_schema),
                         kind="ddl", target=d.table)
            if plan is not None and plan.precision_decisions:
                # likewise the f32 sources of quantised tables: the
                # quantisation conversion reads them (a column copy's
                # f32 twin, or the row table itself)
                emit("-- QUANTISE source tables (f32; load/convert "
                     "here, then run the quantisation)", kind="comment")
                for pd in plan.precision_decisions:
                    emit(self._ddl(pd.table, pd.schema),
                         kind="ddl", target=pd.table)
            emit("-- input / cache table DDL", kind="comment")
            for name, schema in self.p.input_schemas.items():
                # planner-chosen cache layout: the key-column order IS
                # the physical clustering (row_chunk / head_major / …)
                emit(annotate(name, self._ddl(name, schema)),
                     kind="ddl", target=name)
        if include_conversion and plan is not None and (
                plan.col_decisions or plan.precision_decisions):
            emit("-- ROW2COL data conversion (planner layout "
                 "choices; run after loading the row tables)",
                 kind="comment")
            emit(plan.conversion_sql(self.dialect), kind="conversion",
                 tables=tuple(sorted(
                     {d.table for d in plan.col_decisions}
                     | {pd.table for pd in plan.precision_decisions})))
        if include_conversion and shard_plan is not None \
                and shard_plan.decisions:
            # per-shard table slices: contiguous key ranges of the stored
            # tables (runs after layout/quantise conversions — the slices
            # may read column copies or quantised twins)
            emit("-- SHARD data conversion (contiguous key-range slices "
                 "of the stored weight tables)", kind="comment")
            done = set()
            for d in shard_plan.decisions:
                if d.table in done:
                    continue
                done.add(d.table)
                for s, (lo, hi) in enumerate(d.ranges):
                    tgt = d.shard_table(s)
                    emit(f"CREATE OR REPLACE TABLE {_sn(tgt)} AS\n"
                         f"SELECT * FROM {_sn(d.table)} "
                         f"WHERE {_sn(d.axis)} >= {lo} "
                         f"AND {_sn(d.axis)} < {hi};",
                         kind="conversion", target=tgt,
                         tables=(d.table,), shard=s)
        for step in self.p.steps:
            root = step.rel.plan
            if step.kind == "bind":
                decs = (shard_plan.by_step.get(step.name, ())
                        if shard_plan is not None else ())
                for i, dec in enumerate(decs):
                    # per-shard partial relations, then the combine: the
                    # step view below references the combine by name (the
                    # sharded aggregate is registered as a named root)
                    for s, shard_root in enumerate(dec.shard_roots):
                        nm = f"{step.name}::s{i}::shard{s}"
                        ops, tables = plan_provenance(shard_root)
                        emit(self.render_step_sql(nm, shard_root,
                                                  create=step_create),
                             kind="bind", step=step.name, target=nm,
                             tables=tables, ops=ops,
                             quantised=tuple(t for t in tables
                                             if t in qset), shard=s)
                        self.named_roots[id(shard_root)] = _sn(nm)
                    cname = f"{step.name}::s{i}::combine"
                    emit(self._shard_combine_sql(dec, i, step.name,
                                                 step_create),
                         kind="bind", step=step.name, target=cname,
                         tables=tuple(dec.shard_table(s)
                                      for s in range(dec.n_shards)),
                         ops=("shard_combine",))
                    self.named_roots[id(dec.agg)] = _sn(cname)
                emit(self.render_step_sql(step.name, root,
                                          create=step_create),
                     kind="bind", target=step.name, **step_prov(step, root))
                self.named_roots[id(root)] = _sn(step.name)
            else:  # append — KV-cache INSERT (§3.4)
                ctes: List[Tuple[str, str]] = []
                sel = self.render_select(root, ctes)
                if ctes:
                    with_clause = ",\n  ".join(
                        f"{n} AS ({sql})" for n, sql in ctes)
                    sel = f"WITH {with_clause}\n{sel}"
                sel_s = resolve(root)
                if step.seq_key:
                    # batched append: the SELECT has one row per sequence
                    # and no position key — wrap it to compute each row's
                    # INSERT position from the per-sequence parameter
                    # vector, in the cache table's physical key order
                    cache_s = self.p.input_schemas[step.name]
                    pos = self._key_param(step.offset_name,
                                          f"S.{_sn(step.seq_key)}")
                    parts = [f"{pos} AS {_sn(k)}" if k == step.append_key
                             else f"S.{_sn(k)}" for k in cache_s.key_names]
                    parts += [f"S.{_sn(c)}" for c in sel_s.col_names]
                    sel = (f"SELECT {', '.join(parts)} FROM (\n{sel}\n"
                           f") AS S")
                    collist = ", ".join(
                        _sn(c) for c in cache_s.key_names + sel_s.col_names)
                    emit(f"-- batched KV-cache append (per-seq rows at "
                         f":{step.offset_name}[seq])\n"
                         f"INSERT INTO {_sn(step.name)} ({collist})\n{sel};",
                         kind="append", target=step.name,
                         **step_prov(step, root))
                    continue
                # name the target columns: the cache table's physical key
                # order is planner-chosen and need not match the SELECT's
                collist = ", ".join(
                    _sn(c) for c in sel_s.key_names + sel_s.col_names)
                emit(f"-- KV-cache append (new rows at "
                     f":{step.offset_name})\n"
                     f"INSERT INTO {_sn(step.name)} ({collist})\n{sel};",
                     kind="append", target=step.name,
                     **step_prov(step, root))
        return out

    def _shard_combine_sql(self, dec, idx: int, step_name: str,
                           create: str) -> str:
        """The combine relation over one site's per-shard partials:
        ``UNION ALL`` + per-group SUM for row-parallel sites (every shard
        emits the full group set of partial sums), a plain key-disjoint
        UNION for column/head-parallel sites (each shard owns a
        contiguous range of the shard key, so the union IS the full
        relation)."""
        agg_s = resolve(dec.agg)
        names = [_sn(f"{step_name}::s{idx}::shard{s}")
                 for s in range(dec.n_shards)]
        union = "\nUNION ALL\n".join(f"SELECT * FROM {n}" for n in names)
        target = _sn(f"{step_name}::s{idx}::combine")
        if dec.combine == "concat":
            return (f"CREATE OR REPLACE {create} {target} AS\n"
                    f"-- key-disjoint shard combine "
                    f"(contiguous {_sn(dec.axis)} ranges)\n{union};")
        keys = [_sn(k) for k in agg_s.key_names]
        parts = list(keys)
        for c, t in agg_s.cols:
            if is_vec(t):
                parts.append(f"sumForEach(LIST({_sn(c)})) AS {_sn(c)}")
            else:
                parts.append(f"SUM({_sn(c)}) AS {_sn(c)}")
        gb = f"\nGROUP BY {', '.join(keys)}" if keys else ""
        return (f"CREATE OR REPLACE {create} {target} AS\n"
                f"-- row-parallel shard combine (UNION ALL + SUM over "
                f"partial sums)\n"
                f"SELECT {', '.join(parts)} FROM (\n{union}\n) AS S{gb};")

    @staticmethod
    def _ddl(name: str, schema: RelSchema) -> str:
        cols = [f"{_sn(k)} INT32" for k in schema.key_names]
        for c, t in schema.cols:
            if is_vec(t):
                cols.append(f"{_sn(c)} FLOAT[{vec_width(t)}]")
            else:
                cols.append(f"{_sn(c)} FLOAT")
        return f"CREATE TABLE {_sn(name)} ({', '.join(cols)});"


def generate_sql(pipeline: RelPipeline, dialect: str = "duckdb",
                 include_ddl: bool = True,
                 include_conversion: bool = False,
                 step_create: str = "VIEW") -> str:
    return SQLGenerator(pipeline, dialect=dialect).generate(
        include_ddl, include_conversion=include_conversion,
        step_create=step_create)


def generate_sql_with_provenance(
        pipeline: RelPipeline, dialect: str = "duckdb",
        include_ddl: bool = True, include_conversion: bool = False,
        step_create: str = "VIEW") -> List[Tuple[str, StatementProvenance]]:
    """Like :func:`generate_sql` but returns ``(sql, provenance)`` pairs —
    the observability layer's entry point for per-statement attribution
    (:mod:`repro_torch.obs.dbtrace`)."""
    return SQLGenerator(pipeline, dialect=dialect).generate_with_provenance(
        include_ddl, include_conversion=include_conversion,
        step_create=step_create)


# -- prefix-cache segment binding (serving.kvcache.PrefixCache) --------------


def _segment_parts(schema: RelSchema, seq_id: int,
                   seq_key: str) -> Tuple[str, str]:
    """(seq-remapped SELECT list, plain column list) for a batched cache
    schema — the segment table carries the same columns minus ``seq``."""
    names = list(schema.key_names) + list(schema.col_names)
    remapped = ", ".join(f"{seq_id} AS {_sn(seq_key)}" if n == seq_key
                         else _sn(n) for n in names)
    collist = ", ".join(_sn(n) for n in names)
    return remapped, collist


def segment_remap_view_sql(view_name: str, cache_table: str,
                           segment_table: str, seq_id: int, boundary: int,
                           schema: RelSchema, seq_key: str = "seq",
                           pos_key: str = "tp",
                           dialect: str = "duckdb") -> str:
    """Share-mode segment bind as SQL: the sequence's cache view is the
    shared segment's rows ``[0, boundary)`` re-keyed to this ``seq``,
    UNION ALL the slot's own rows at and past the boundary.  This is the
    relational statement :meth:`BatchedCacheTables.gather_views` computes
    on the tensor side for a bound slot — zero rows are copied; the view is
    the binding.

    ``schema`` is the *batched* cache table's schema (leading ``seq``
    key); the segment table carries the same columns minus ``seq``.
    Plain ANSI SQL — both dialects emit identical text (asserted by the
    e2e golden test).
    """
    assert dialect in ("duckdb", "ansi")
    remapped, collist = _segment_parts(schema, seq_id, seq_key)
    return (
        f"CREATE OR REPLACE VIEW {_sn(view_name)} AS\n"
        f"-- prefix-segment remap: shared rows [0, {boundary}) re-keyed "
        f"to {_sn(seq_key)} = {seq_id}\n"
        f"SELECT {remapped} FROM {_sn(segment_table)} "
        f"WHERE {_sn(pos_key)} < {boundary}\n"
        f"UNION ALL\n"
        f"SELECT {collist} FROM {_sn(cache_table)} "
        f"WHERE {_sn(seq_key)} = {seq_id} "
        f"AND {_sn(pos_key)} >= {boundary};")


def segment_copy_sql(cache_table: str, segment_table: str, seq_id: int,
                     boundary: int, schema: RelSchema,
                     seq_key: str = "seq", pos_key: str = "tp",
                     dialect: str = "duckdb") -> str:
    """Copy-mode segment bind as SQL: bulk-copy the shared rows into the
    sequence's own slot (``INSERT ... SELECT``) — what the planner picks
    when pricing the remap view's per-read UNION as dearer than one
    write (:meth:`BatchedDecoder._resolve_bind`).  Counterpart of
    :meth:`BatchedCacheTables.write_prefill`'s full-slot device copy."""
    assert dialect in ("duckdb", "ansi")
    remapped, collist = _segment_parts(schema, seq_id, seq_key)
    return (
        f"-- prefix-segment bulk copy (copy-mode bind)\n"
        f"INSERT INTO {_sn(cache_table)} ({collist})\n"
        f"SELECT {remapped} FROM {_sn(segment_table)} "
        f"WHERE {_sn(pos_key)} < {boundary};")
