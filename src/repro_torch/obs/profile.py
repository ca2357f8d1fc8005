"""DuckDB ``EXPLAIN ANALYSE`` / JSON-profile parsing and attribution.

Pure-JSON: no duckdb import — the parser is exercised against
checked-in profile fixtures in tier-1 and against live profiles only in
the duckdb-gated tier (:mod:`repro_torch.obs.dbtrace`).

DuckDB's profile JSON changed key sets across versions:

* ≤ 0.9:  ``{"name": ..., "timing": ..., "cardinality": ...,
  "extra_info"/"extra-info": "<text>", "children": [...]}`` with the
  query total in ``"result"``;
* ≥ 0.10: ``{"operator_type": ..., "operator_timing": ...,
  "operator_cardinality": ..., "extra_info": {...}, "children": [...]}``
  with the total in ``"latency"`` and a ``"query_name"`` root.

:func:`parse_profile` normalises both into an :class:`OpNode` tree;
:func:`attribute_statement` maps each operator's wall time back to the
pipeline step and relational op class that generated the statement,
using the ``StatementProvenance`` tags emitted by
``core/sqlgen.SQLGenerator.generate_with_provenance``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple, Union

# DuckDB physical operator → relational op class.  Keys are matched on
# the operator name upper-cased with spaces collapsed to underscores;
# unknown operators fall back to "other" (still attributed to the
# statement's step — the step provenance is what the coverage
# criterion counts).
OPERATOR_CLASSES = {
    "SEQ_SCAN": "scan",
    "TABLE_SCAN": "scan",
    "COLUMN_DATA_SCAN": "scan",
    "READ_CSV_AUTO": "scan",
    "DUMMY_SCAN": "scan",
    "HASH_JOIN": "join",
    "PIECEWISE_MERGE_JOIN": "join",
    "NESTED_LOOP_JOIN": "join",
    "BLOCKWISE_NL_JOIN": "join",
    "CROSS_PRODUCT": "join",
    "IE_JOIN": "join",
    "ASOF_JOIN": "join",
    "PROJECTION": "project",
    "FILTER": "filter",
    "HASH_GROUP_BY": "aggregate",
    "PERFECT_HASH_GROUP_BY": "aggregate",
    "UNGROUPED_AGGREGATE": "aggregate",
    "SIMPLE_AGGREGATE": "aggregate",
    "WINDOW": "aggregate",
    "ORDER_BY": "sort",
    "TOP_N": "sort",
    "UNNEST": "unnest",
    "INSERT": "insert",
    "CREATE_TABLE_AS": "insert",
    "BATCH_INSERT": "insert",
}


@dataclasses.dataclass
class OpNode:
    """One operator of a normalised profile tree."""

    operator: str
    timing_s: float
    cardinality: int
    extra: Union[str, Dict]
    children: List["OpNode"] = dataclasses.field(default_factory=list)

    @property
    def self_timing_s(self) -> float:
        # DuckDB operator timings are per-operator (not inclusive of
        # children), so the node's own time IS its reported timing
        return self.timing_s


@dataclasses.dataclass
class AttributedOp:
    """One profiled operator attributed to its generating pipeline step."""

    step: Optional[str]     # pipeline step name (None: prelude/DDL/conv)
    statement_kind: str     # "bind" | "append" | "ddl" | ...
    op_class: str           # scan / join / project / dequant_project / ...
    operator: str           # raw DB operator name
    table: Optional[str]    # scanned table, when the profile names one
    time_s: float
    cardinality: int


def _norm_operator(name: str) -> str:
    return str(name).strip().upper().replace(" ", "_")


def parse_profile(profile: Union[str, Dict]) -> OpNode:
    """Normalise a DuckDB profile JSON (object or string) to an OpNode
    tree.  The root node is the query itself (operator ``"QUERY"``) with
    the total latency when the profile reports one."""
    if isinstance(profile, str):
        profile = json.loads(profile)
    name = profile.get("query_name") or profile.get("name") or "QUERY"
    is_query_root = (_norm_operator(name) == "QUERY"
                     or "query_name" in profile or "latency" in profile
                     or "result" in profile)
    if not is_query_root:
        # bare operator tree (no query wrapper): wrap it so callers
        # always see a QUERY root
        return OpNode(operator="QUERY", timing_s=0.0, cardinality=0,
                      extra="", children=[_parse_node(profile)])
    total = profile.get("latency", profile.get("result",
                                               profile.get("timing", 0.0)))
    return OpNode(operator="QUERY",
                  timing_s=float(total or 0.0), cardinality=0,
                  extra=profile.get("extra_info",
                                    profile.get("extra-info", "")),
                  children=[_parse_node(c)
                            for c in profile.get("children", [])])


def _parse_node(obj: Dict) -> OpNode:
    name = (obj.get("operator_type") or obj.get("operator_name")
            or obj.get("name") or "UNKNOWN")
    timing = obj.get("operator_timing", obj.get("timing", 0.0))
    card = obj.get("operator_cardinality", obj.get("cardinality", 0))
    extra = obj.get("extra_info", obj.get("extra-info", ""))
    return OpNode(operator=_norm_operator(name),
                  timing_s=float(timing or 0.0),
                  cardinality=int(card or 0), extra=extra,
                  children=[_parse_node(c) for c in obj.get("children", [])])


def flatten_profile(root: OpNode) -> List[OpNode]:
    """Every operator node of the tree (excluding the QUERY root)."""
    out: List[OpNode] = []

    def rec(n: OpNode):
        if n.operator != "QUERY":
            out.append(n)
        for c in n.children:
            rec(c)

    rec(root)
    return out


def _extra_text(extra: Union[str, Dict]) -> str:
    if isinstance(extra, dict):
        return " ".join(f"{k}={v}" for k, v in extra.items())
    return str(extra or "")


def scanned_table(node: OpNode) -> Optional[str]:
    """The table a scan operator reads, when the profile names one."""
    extra = node.extra
    if isinstance(extra, dict):
        for key in ("Table", "table", "Text", "text"):
            if key in extra:
                return str(extra[key]).strip().split("\n")[0] or None
        return None
    text = str(extra or "").strip()
    return text.split("\n")[0] or None if text else None


def classify_operator(operator: str,
                      provenance=None) -> str:
    """Map a DB operator name to a relational op class, refined by the
    generating statement's provenance: projections over quantised tables
    are the planner's dequantising projections, inserts into a cache
    table are cache appends."""
    cls = OPERATOR_CLASSES.get(_norm_operator(operator), "other")
    if provenance is not None:
        if cls == "project" and getattr(provenance, "quantised", ()):
            cls = "dequant_project"
        if cls == "insert" and getattr(provenance, "kind", "") == "append":
            cls = "cache_append"
    return cls


def attribute_statement(root: OpNode, provenance) -> List[AttributedOp]:
    """Attribute every operator of one statement's profile to the
    pipeline step / op class recorded in its provenance tag."""
    step = getattr(provenance, "step", None)
    kind = getattr(provenance, "kind", "unknown")
    out = []
    for node in flatten_profile(root):
        cls = classify_operator(node.operator, provenance)
        out.append(AttributedOp(
            step=step, statement_kind=kind, op_class=cls,
            operator=node.operator,
            table=scanned_table(node) if cls == "scan" else None,
            time_s=node.self_timing_s, cardinality=node.cardinality))
    return out


# ---------------------------------------------------------------------------
# SQLite EXPLAIN QUERY PLAN (the ansi dialect's profile source)
# ---------------------------------------------------------------------------


def classify_eqp_detail(detail: str,
                        first_in_parent: bool = True
                        ) -> Tuple[str, str, Optional[str]]:
    """Classify one SQLite ``EXPLAIN QUERY PLAN`` detail string into
    ``(op_class, operator, table)``.

    SQLite's EQP rows describe the access path per table term: ``SCAN t``
    (full scan), ``SEARCH t USING ...`` (indexed lookup), ``USE TEMP
    B-TREE FOR ORDER BY`` (sort), plus subquery/co-routine scaffolding.
    SQLite never says "join" — a join is simply the second and later
    SCAN/SEARCH terms nested under the same parent (the inner loops of
    its nested-loop join), which is what ``first_in_parent=False``
    marks.
    """
    text = str(detail or "").strip()
    up = text.upper()
    if up.startswith("SCAN ") or up.startswith("SEARCH "):
        kw, rest = text.split(None, 1)
        if rest.upper().startswith("TABLE "):  # pre-3.36 phrasing
            rest = rest.split(None, 1)[1]
        table = rest.split()[0].strip('"') or None
        base = "scan" if kw.upper() == "SCAN" else "search"
        return (base if first_in_parent else "join"), kw.upper(), table
    if "B-TREE" in up:
        return "sort", "USE_TEMP_B-TREE", None
    if up.startswith(("SCALAR SUBQUERY", "LIST SUBQUERY", "CORRELATED")):
        return "other", "SUBQUERY", None
    if up.startswith(("CO-ROUTINE", "MATERIALIZE")):
        return "other", up.split()[0], None
    if up.startswith(("COMPOUND", "UNION", "MERGE")):
        return "other", "COMPOUND", None
    return "other", (up.split()[0] if up else "UNKNOWN"), None


def attribute_query_plan(rows: Sequence, provenance,
                         wall_s: float) -> List[AttributedOp]:
    """Attribute a statement's SQLite ``EXPLAIN QUERY PLAN`` rows to its
    generating pipeline step — the ansi-dialect counterpart of
    :func:`attribute_statement`.

    ``rows`` are the cursor rows ``(id, parent, notused, detail)``.
    SQLite reports no per-operator timings, so the statement's measured
    ``wall_s`` is split evenly across its operator rows: per-*step*
    totals (what the drift report joins on) stay exact, while the
    operator structure (scan vs search vs join inner loop) becomes
    visible per statement.
    """
    step = getattr(provenance, "step", None)
    kind = getattr(provenance, "kind", "unknown")
    parsed = []
    seen_per_parent: Dict[int, int] = {}
    for row in rows:
        try:
            parent = int(row[1])
            detail = row[3]
        except (IndexError, TypeError, ValueError):
            continue
        up = str(detail or "").strip().upper()
        is_table_term = up.startswith(("SCAN ", "SEARCH "))
        first = seen_per_parent.get(parent, 0) == 0
        if is_table_term:
            seen_per_parent[parent] = seen_per_parent.get(parent, 0) + 1
        cls, op, table = classify_eqp_detail(detail, first_in_parent=first)
        parsed.append((cls, op, table))
    if not parsed:
        return []
    share = float(wall_s) / len(parsed)
    return [AttributedOp(step=step, statement_kind=kind, op_class=cls,
                         operator=op, table=table, time_s=share,
                         cardinality=0)
            for cls, op, table in parsed]


def coverage(attributed: List[AttributedOp],
             total_s: Optional[float] = None) -> float:
    """Fraction of measured time attributed to *named* pipeline steps.

    ``total_s`` defaults to the summed operator time (profile-measured
    tick time); pass the python-measured wall time to compute coverage
    against an external clock instead.
    """
    if total_s is None:
        total_s = sum(a.time_s for a in attributed)
    if total_s <= 0:
        return 0.0
    named = sum(a.time_s for a in attributed if a.step is not None)
    return named / total_s


def step_times_us(attributed: List[AttributedOp]) -> Dict[str, float]:
    """Observed per-step operator time (µs) — the drift report's input."""
    out: Dict[str, float] = {}
    for a in attributed:
        if a.step is not None:
            out[a.step] = out.get(a.step, 0.0) + a.time_s * 1e6
    return out


def class_times_us(attributed: List[AttributedOp]) -> Dict[str, float]:
    """Observed time (µs) per relational op class across statements."""
    out: Dict[str, float] = {}
    for a in attributed:
        out[a.op_class] = out.get(a.op_class, 0.0) + a.time_s * 1e6
    return out
