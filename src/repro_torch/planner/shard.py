"""Sharded relational execution — a tensor-parallel axis for the planner.

The paper's matmul-as-join formulation is embarrassingly partitionable
along the weight tables' column-chunk / head keys: every matmul bind is a

    GroupAgg(Join(x, Scan(W)))

whose weight Scan can be split into N contiguous key-range slices, each
producing an independent partial relation, recombined by ONE extra
relational operator.  This module makes that split a *planner* decision:
:func:`plan_shards` walks a compiled pipeline's bind steps, matches the
shardable matmul sites (reusing the join/aggregate legality shape behind
``planner.layout.match_matmul_site``), prices the split against the
combine overhead with the :class:`~repro_torch.planner.cost.CostParams`
weights, and records a :class:`ShardPlan` carrying per-shard plan copies
that scan ``{table}::shard{s}`` slices.

Three site kinds, keyed by which weight key the join binds — the
relational analogue of the classic tensor-parallel split taxonomy:

  row   — the join binds the weight's *reduction* chunk key (ROW_CHUNK
          tables).  Each shard owns a contiguous slice of the input
          chunks and produces a full-shaped partial sum; the combine is
          ``UNION ALL`` + per-group SUM (row-parallel / allreduce).
  col   — the join binds ``d`` of a two-key COL_CHUNK table.  Each shard
          owns a slice of the *output* chunk key; partials are key-
          disjoint and the combine is a plain UNION (column-parallel /
          allgather).
  colh  — the join binds ``d`` of a three-key COL_CHUNK_HEADS table.
          The shard axis is the head block key (head-parallel attention);
          combine is a key-disjoint UNION along ``h``.

Legality additionally consults the sharding vocabulary in
``DEFAULT_RULES`` (``repro_torch.distributed.sharding``): a
site is only eligible when its logical axis ("heads" / "kv_heads" /
"vocab" / "mlp" / "inner") maps to a non-empty mesh-axis rule.

Execution halves live elsewhere: ``core.sqlgen`` renders the per-shard
DDL + per-shard views + combine relation; ``serving.shards.
ShardWorkerPool`` runs the per-shard plan copies through
``run_pipeline(shard_runner=...)``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.relational import (
    GroupAgg, Join, Key, Project, RelNode, RelSchema, Scan, resolve, walk,
)
from repro_torch.distributed.sharding import DEFAULT_RULES
from repro_torch.planner.cost import CostParams

SHARD_SEP = "::shard"

# combine operator per site kind
COMBINE_SUM = "sum"        # UNION ALL + per-group SUM  (row-parallel)
COMBINE_CONCAT = "concat"  # key-disjoint UNION         (col/head-parallel)


def shard_table_name(table: str, shard: int) -> str:
    """Physical name of one contiguous key-range slice of ``table``."""
    return f"{table}{SHARD_SEP}{shard}"


def balanced_ranges(size: int, n: int) -> Tuple[Tuple[int, int], ...]:
    """Split ``range(size)`` into ``n`` contiguous near-equal ranges."""
    n = max(1, min(int(n), int(size)))
    return tuple((i * size // n, (i + 1) * size // n) for i in range(n))


def _slice_schema(schema: RelSchema, axis: str, lo: int, hi: int
                  ) -> RelSchema:
    """Schema of a contiguous ``axis``-range slice (local size ``hi-lo``)."""
    return RelSchema(
        keys=tuple((k, hi - lo if k == axis else s) for k, s in schema.keys),
        cols=schema.cols)


@dataclasses.dataclass
class ShardDecision:
    """One sharded matmul site: where to split, how to recombine, and the
    per-shard plan copies the workers execute.

    The runtime node references (``agg``/``join``/``scan``/``left``) point
    INTO the live pipeline plan — the coordinator seeds its memo at
    ``id(agg)`` with the combined relation, so the step's unsharded tail
    (re-chunk projections, collects) runs exactly once on top.
    ``shard_roots[s]`` is a structural copy of the GroupAgg subtree along
    the weight-scan path only (the left/activation subtree is shared by
    reference): its Scan reads ``{table}::shard{s}`` at the LOCAL
    shard-axis size, so schema resolution, the fused join-agg kernel and
    SQL generation all see a self-consistent slice-sized plan.
    """

    step_name: str
    table: str                 # stored table being sliced (q-table when
    #                            the site scans a quantised payload)
    axis: str                  # shard key name in the stored table
    axis_size: int             # global key-domain size K of ``axis``
    kind: str                  # "row" | "col" | "colh"
    combine: str               # COMBINE_SUM | COMBINE_CONCAT
    logical_axis: str          # DEFAULT_RULES vocabulary label
    ranges: Tuple[Tuple[int, int], ...]
    # pricing (CostParams units)
    benefit: float = 0.0
    combine_cost: float = 0.0
    # live plan nodes (identity matters — not copies)
    agg: Optional[GroupAgg] = None
    join: Optional[Join] = None
    scan: Optional[Scan] = None
    dequant: Optional[Project] = None   # inline dequant over a q-table scan
    left: Optional[RelNode] = None      # join.left, shared with shard_roots
    left_key: Optional[str] = None      # left join key (row sites: the axis
    #                                     the activation is sliced along)
    shard_roots: List[GroupAgg] = dataclasses.field(default_factory=list)

    @property
    def n_shards(self) -> int:
        return len(self.ranges)

    def shard_table(self, s: int) -> str:
        return shard_table_name(self.table, s)


@dataclasses.dataclass
class ShardPlan:
    """Outcome of shard planning over one pipeline."""

    n_shards: int
    decisions: List[ShardDecision] = dataclasses.field(default_factory=list)
    # step name -> its decisions in post-order (inner sites first), so the
    # runner can combine nested sites bottom-up
    by_step: Dict[str, List[ShardDecision]] = dataclasses.field(
        default_factory=dict)
    # stored table -> per-shard (lo, hi) key ranges along its shard axis
    table_ranges: Dict[str, Tuple[Tuple[int, int], ...]] = dataclasses.field(
        default_factory=dict)

    def add(self, d: ShardDecision) -> None:
        self.decisions.append(d)
        self.by_step.setdefault(d.step_name, []).append(d)
        self.table_ranges[d.table] = d.ranges


# ---------------------------------------------------------------------------
# Site matching
# ---------------------------------------------------------------------------


def logical_shard_axis(kind: str, table: str) -> str:
    """Map a site to the ``distributed.sharding`` vocabulary label."""
    t = table.lower()
    if kind == "colh":
        return "kv_heads" if ("k_" in t or "v_" in t or "kv" in t) \
            else "heads"
    if "vocab" in t or "lm_head" in t or "logit" in t:
        return "vocab"
    if any(s in t for s in ("w1", "w2", "w3", "ffn", "mlp", "up_",
                            "down_", "gate")):
        return "mlp"
    return "inner"


def match_shard_site(step_name: str, agg: GroupAgg, cache_tables,
                     ) -> Optional[ShardDecision]:
    """Classify one GroupAgg as a shardable matmul site, or None.

    Shape: ``GroupAgg(Join(left, Scan(W) | π_dequant(Scan(W_q))))`` with a
    single equi-join condition binding a weight key to a plain left Key
    expression (value joins — embedding lookups — bind a Col and are
    skipped), and a single SUM aggregate.  Cache-table scans (attention)
    are excluded by name.
    """
    join = agg.input
    if not isinstance(join, Join) or getattr(join, "how", "inner") != "inner":
        return None
    right = join.right
    dequant: Optional[Project] = None
    if isinstance(right, Project) and right.keys is None \
            and isinstance(right.input, Scan):
        dequant, scan = right, right.input
    elif isinstance(right, Scan):
        scan = right
    else:
        return None
    if scan.table in cache_tables:
        return None
    if len(join.on) != 1:
        return None
    jkey, jexpr = join.on[0]
    if not isinstance(jexpr, Key):
        return None
    if len(agg.aggs) != 1 or agg.aggs[0][1] != "SUM":
        return None
    ws = scan.table_schema
    if jkey not in ws.key_names:
        return None

    if jkey == ws.keys[-1][0]:
        # the join binds the weight's trailing (reduction) chunk key:
        # row-parallel split along the input chunks, combine by SUM
        kind, axis, combine = "row", jkey, COMBINE_SUM
        if axis in agg.group_keys:
            return None      # a surviving reduction key is not a matmul
        left_s = resolve(join.left)
        if jexpr.name not in left_s.key_names:
            return None
        if left_s.key_size(jexpr.name) != ws.key_size(axis):
            return None
    elif len(ws.keys) == 2 and jkey == ws.keys[0][0]:
        # COL_CHUNK: join binds d, shard the output-chunk key
        kind, axis, combine = "col", ws.keys[-1][0], COMBINE_CONCAT
        if axis not in agg.group_keys:
            return None
    elif len(ws.keys) == 3 and jkey == ws.keys[1][0]:
        # COL_CHUNK_HEADS: join binds d, shard the head block key
        kind, axis, combine = "colh", ws.keys[0][0], COMBINE_CONCAT
        if ws.keys[0][0] not in agg.group_keys:
            return None
    else:
        return None

    k = ws.key_size(axis)
    if k < 2:
        return None
    logical = logical_shard_axis(kind, scan.table)
    if not DEFAULT_RULES.get(logical):
        return None          # axis the sharding vocabulary keeps replicated
    return ShardDecision(
        step_name=step_name, table=scan.table, axis=axis, axis_size=k,
        kind=kind, combine=combine, logical_axis=logical, ranges=(),
        agg=agg, join=join, scan=scan, dequant=dequant, left=join.left,
        left_key=jexpr.name if combine == COMBINE_SUM else None)


# ---------------------------------------------------------------------------
# Pricing
# ---------------------------------------------------------------------------


def _prod_sizes(keys) -> float:
    out = 1.0
    for _, s in keys:
        out *= max(1, s)
    return out


def price_shard(dec: ShardDecision, n: int, params: CostParams
                ) -> Tuple[float, float]:
    """(benefit, combine_cost) of splitting one site ``n`` ways.

    The split removes ``(1 - 1/n)`` of the site's serial join + group
    work from the critical path; the combine adds one pass over the
    output groups — N stacked copies for SUM sites (every shard emits the
    full group set), one disjoint copy for CONCAT sites.
    """
    join_rows = _prod_sizes(resolve(dec.join).keys)
    groups = _prod_sizes(resolve(dec.agg).keys)
    site_cost = params.row_weight * join_rows + params.group_weight * groups
    n_eff = max(1, min(n, dec.axis_size))
    benefit = site_cost * (1.0 - 1.0 / n_eff)
    stacked = n_eff if dec.combine == COMBINE_SUM else 1
    combine_cost = params.row_weight * groups * stacked
    return benefit, combine_cost


# ---------------------------------------------------------------------------
# Per-shard plan copies
# ---------------------------------------------------------------------------


def _build_shard_roots(dec: ShardDecision) -> List[GroupAgg]:
    """Structural copies of the GroupAgg subtree along the weight-scan
    path, one per shard.  The left subtree is SHARED by reference (the
    runner seeds it with the coordinator-computed — and, for row sites,
    pre-sliced — activation).  Copies carry no resolved schemas, so
    ``resolve`` re-derives local sizes from the slice-sized Scan."""
    roots: List[GroupAgg] = []
    for s, (lo, hi) in enumerate(dec.ranges):
        scan = Scan(table=dec.shard_table(s),
                    table_schema=_slice_schema(dec.scan.table_schema,
                                               dec.axis, lo, hi))
        right: RelNode = scan
        if dec.dequant is not None:
            right = Project(input=scan, keys=None,
                            exprs=list(dec.dequant.exprs))
        join = Join(left=dec.left, right=right,
                    on=list(dec.join.on), how=dec.join.how)
        roots.append(GroupAgg(input=join,
                              group_keys=list(dec.agg.group_keys),
                              aggs=list(dec.agg.aggs)))
    return roots


# ---------------------------------------------------------------------------
# The planning pass
# ---------------------------------------------------------------------------


def plan_shards(pipeline, n_shards: int,
                params: Optional[CostParams] = None) -> ShardPlan:
    """Match, price and record the shard plan for a compiled pipeline.

    Walks bind steps in order (post-order within each step, so nested
    sites are recorded inner-first), dedupes shared-DAG aggregates by
    identity, and admits each site only when the priced benefit exceeds
    the combine overhead.  The pipeline's relational plans are NOT
    rewritten — at ``n_shards == 1`` (or with every site refused) the
    compiled pipeline, its SQL and its execution are bit-identical to an
    unsharded one.  Records the plan on ``pipeline.shard_plan``.
    """
    n_shards = int(n_shards)
    if n_shards < 2:
        pipeline.shard_plan = None
        return ShardPlan(n_shards=max(1, n_shards))
    params = params or CostParams()
    plan = ShardPlan(n_shards=n_shards)
    cache_tables = set(getattr(pipeline, "cache_tables", {}) or {})
    seen: set = set()
    for step in pipeline.steps:
        if step.kind != "bind":
            continue
        for node in walk(step.rel.plan):
            if not isinstance(node, GroupAgg) or id(node) in seen:
                continue
            seen.add(id(node))
            dec = match_shard_site(step.name, node, cache_tables)
            if dec is None:
                continue
            benefit, combine_cost = price_shard(dec, n_shards, params)
            if benefit <= combine_cost:
                continue
            dec.ranges = balanced_ranges(dec.axis_size, n_shards)
            dec.benefit, dec.combine_cost = benefit, combine_cost
            dec.shard_roots = _build_shard_roots(dec)
            plan.add(dec)
    pipeline.shard_plan = plan if plan.decisions else None
    return plan
