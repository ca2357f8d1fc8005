"""Traced execution of a compiled pipeline's SQL against a real DB.

Layer 1 of the observability stack, DB side: run each statement of a
generated script (``core/sqlgen.generate_sql_with_provenance``) one at a
time and attribute where the engine spent its time.

* On DuckDB, every traced statement runs under
  ``PRAGMA enable_profiling='json'`` (the engine's EXPLAIN ANALYSE
  payload written to a file); the profile tree is parsed by
  :mod:`repro_torch.obs.profile` and each operator's wall time is attributed
  back to the generating pipeline step / relational op class through the
  statement's :class:`~repro_torch.core.sqlgen.StatementProvenance` tag.
* On engines without JSON profiling (SQLite), :func:`run_timed` times
  each statement and attributes its wall time across the operator rows
  of ``EXPLAIN QUERY PLAN`` (scan / search / join inner loop); DDL and
  non-SQLite engines fall back to one ``op_class="statement"`` record
  per statement.  (The generated LLM scripts need vector UDFs SQLite
  lacks, so in practice the SQLite path times plain SQL, e.g.
  micro-benchmarks.)

duckdb is an *optional* dependency: nothing here imports it at module
level — :func:`run_traced` takes an already-open connection, so tier-1
never needs the package.  Per-step DB attribution only sees work if the
bind steps materialise (``step_create="TABLE"``): views are lazy, a
``CREATE VIEW`` statement does no scanning at CREATE time.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.context import current_context
from repro_torch.obs.profile import (
    AttributedOp, OpNode, attribute_query_plan, attribute_statement,
    class_times_us, coverage, parse_profile, step_times_us,
)
from repro_torch.obs.trace import TraceRecorder


def split_statements(sql: str) -> List[str]:
    """Split one emitted SQL segment into executable statements,
    dropping ``--`` comment lines (the segments carry planner-annotation
    comments that some drivers reject as bare statements)."""
    out = []
    for stmt in sql.split(";"):
        body = "\n".join(l for l in stmt.splitlines()
                         if not l.strip().startswith("--")).strip()
        if body:
            out.append(body + ";")
    return out


def substitute_params(sql: str, params: Dict[str, object]) -> str:
    """Textually substitute ``:name`` parameters (the generated scripts
    use named parameters inside view/table bodies, which DB drivers
    don't bind — mirror of the e2e harness' ``re.sub`` idiom)."""
    for name, val in params.items():
        sql = re.sub(rf":{re.escape(name)}\b", str(val), sql)
    return sql


@dataclasses.dataclass
class StatementTrace:
    """One executed statement: wall time, profile, attribution."""

    sql: str
    provenance: object              # core.sqlgen.StatementProvenance
    wall_s: float
    profile: Optional[OpNode]       # None when the engine gave none
    attributed: List[AttributedOp]


@dataclasses.dataclass
class TickTrace:
    """One traced pass over a set of statements (e.g. a decode tick).

    When the pass ran under an active
    :class:`~repro_torch.obs.context.TraceContext` (a traced tick serving
    live requests), ``request_ids``/``trace_ids`` carry the requests it
    served, so DB-operator attribution joins back to the originating
    HTTP requests like every other span."""

    statements: List[StatementTrace]
    request_ids: Tuple[int, ...] = ()
    trace_ids: Tuple[str, ...] = ()

    @property
    def wall_s(self) -> float:
        return sum(s.wall_s for s in self.statements)

    @property
    def attributed(self) -> List[AttributedOp]:
        return [a for s in self.statements for a in s.attributed]

    def coverage(self, total_s: Optional[float] = None) -> float:
        return coverage(self.attributed, total_s)

    def step_times_us(self) -> Dict[str, float]:
        return step_times_us(self.attributed)

    def class_times_us(self) -> Dict[str, float]:
        return class_times_us(self.attributed)

    def to_recorder(self) -> TraceRecorder:
        """Lay the trace out as spans for Chrome-trace export: one
        ``cat="statement"`` span per statement (named by its step), with
        the profiled operators as sequential ``cat="dbop"`` sub-spans —
        operator *durations* are real, their offsets within the
        statement are synthetic (profiles carry no start times)."""
        rec = TraceRecorder()
        ctx_args = {}
        if self.request_ids:
            ctx_args["rids"] = list(self.request_ids)
        if self.trace_ids:
            ctx_args["trace_ids"] = list(self.trace_ids)
        ts = 0.0
        for st in self.statements:
            prov = st.provenance
            name = getattr(prov, "step", None) or getattr(
                prov, "kind", "statement")
            dur = st.wall_s * 1e6
            rec.add_span(name, cat="statement", ts_us=ts, dur_us=dur,
                         depth=0, kind=getattr(prov, "kind", ""),
                         tables=list(getattr(prov, "tables", ())),
                         **ctx_args)
            op_ts = ts
            for a in st.attributed:
                d = a.time_s * 1e6
                rec.add_span(a.operator, cat="dbop", ts_us=op_ts,
                             dur_us=d, depth=1, op_class=a.op_class,
                             cardinality=a.cardinality,
                             **({"table": a.table} if a.table else {}))
                op_ts += d
            ts += dur
        return rec

    def save_chrome(self, path: str) -> None:
        self.to_recorder().save(path)

    def to_dict(self) -> Dict:
        return {
            "wall_s": self.wall_s,
            "request_ids": list(self.request_ids),
            "trace_ids": list(self.trace_ids),
            "coverage": self.coverage(),
            "step_times_us": self.step_times_us(),
            "class_times_us": self.class_times_us(),
            "statements": [
                {"kind": getattr(s.provenance, "kind", ""),
                 "step": getattr(s.provenance, "step", None),
                 "wall_s": s.wall_s,
                 "operators": [dataclasses.asdict(a) for a in s.attributed]}
                for s in self.statements],
        }

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=str)


def run_statements(con, pairs: Sequence[Tuple[str, object]],
                   params: Optional[Dict[str, object]] = None) -> None:
    """Execute ``(sql, provenance)`` pairs untraced (setup: prelude, DDL,
    data conversion) — the traced tick runs via :func:`run_traced`."""
    for sql, _ in pairs:
        if params:
            sql = substitute_params(sql, params)
        for stmt in split_statements(sql):
            con.execute(stmt)


def run_traced(con, pairs: Sequence[Tuple[str, object]],
               params: Optional[Dict[str, object]] = None,
               clock=time.perf_counter) -> TickTrace:
    """Execute ``(sql, provenance)`` pairs on a DuckDB connection with
    JSON profiling, returning per-operator attribution for each.

    ``con`` must be an open DuckDB connection (any object with
    ``execute``); profiling state is restored on exit.  ``params`` are
    substituted textually (:func:`substitute_params`).
    """
    statements: List[StatementTrace] = []
    fd, path = tempfile.mkstemp(suffix=".json", prefix="duckdb_profile_")
    os.close(fd)
    con.execute(f"PRAGMA profiling_output='{path}';")
    con.execute("PRAGMA enable_profiling='json';")
    try:
        for sql, prov in pairs:
            if params:
                sql = substitute_params(sql, params)
            for stmt in split_statements(sql):
                try:
                    os.unlink(path)
                except FileNotFoundError:
                    pass
                t0 = clock()
                con.execute(stmt)
                wall = clock() - t0
                profile = None
                attributed: List[AttributedOp] = []
                try:
                    with open(path) as f:
                        profile = parse_profile(f.read())
                    attributed = attribute_statement(profile, prov)
                except (FileNotFoundError, ValueError, KeyError):
                    pass  # engine produced no profile for this statement
                statements.append(StatementTrace(
                    sql=stmt, provenance=prov, wall_s=wall,
                    profile=profile, attributed=attributed))
    finally:
        con.execute("PRAGMA disable_profiling;")
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass
    return _tick_trace(statements)


def run_timed(con, pairs: Sequence[Tuple[str, object]],
              params: Optional[Dict[str, object]] = None,
              clock=time.perf_counter, explain: bool = True) -> TickTrace:
    """Wall timing plus ``EXPLAIN QUERY PLAN`` attribution for engines
    without JSON profiling (SQLite — the ansi dialect's target).

    Before each statement executes, its query plan is fetched with
    ``EXPLAIN QUERY PLAN`` and the measured wall time is attributed
    across the plan's operator rows (scan / search / join-inner-loop —
    see :func:`repro_torch.obs.profile.attribute_query_plan`); per-step totals
    stay exact since SQLite reports no per-operator timings and the
    split is uniform.  Statements the engine won't explain (DDL, or a
    non-SQLite ``con``) fall back to the old behaviour: one
    ``op_class="statement"`` record carrying the whole wall time.
    ``explain=False`` forces the fallback everywhere.
    """
    statements: List[StatementTrace] = []
    for sql, prov in pairs:
        if params:
            sql = substitute_params(sql, params)
        for stmt in split_statements(sql):
            plan_rows = None
            if explain:
                try:
                    plan_rows = list(
                        con.execute("EXPLAIN QUERY PLAN " + stmt))
                except Exception:
                    plan_rows = None  # engine has no EQP (or DDL quirk)
            t0 = clock()
            con.execute(stmt)
            wall = clock() - t0
            attributed: List[AttributedOp] = []
            if plan_rows:
                attributed = attribute_query_plan(plan_rows, prov, wall)
            if not attributed:
                attributed = [AttributedOp(
                    step=getattr(prov, "step", None),
                    statement_kind=getattr(prov, "kind", "unknown"),
                    op_class="statement", operator="STATEMENT", table=None,
                    time_s=wall, cardinality=0)]
            statements.append(StatementTrace(
                sql=stmt, provenance=prov, wall_s=wall, profile=None,
                attributed=attributed))
    return _tick_trace(statements)


def _tick_trace(statements: List[StatementTrace]) -> TickTrace:
    """Stamp the finished trace with the ambient request context."""
    ctx = current_context()
    return TickTrace(statements=statements,
                     request_ids=ctx.request_ids if ctx else (),
                     trace_ids=ctx.trace_ids if ctx else ())
