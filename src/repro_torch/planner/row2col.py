"""ROW2COL rewrite pass — whole-model cost-based physical layout planning.

``plan_layouts(pipeline, mode)`` walks a compiled ``RelPipeline``, matches
every matmul bind (``Collect(π(γ(x ⋈ Scan(W))))`` — both the two-key
``map_linear`` shape and the three-key per-head ``map_linear_heads``
shape), prices the admissible physical layouts with the
:mod:`repro_torch.planner.cost` model, and rewrites the winners in place to the
column-layout plan:

    ROW_CHUNK                               COL_CHUNK (ROW2COL)
    ---------                               -------------------
    γ_{(t,j), SUM(dot(v, chunk))}           γ_{(t,c), sumForEach(x·chunk)}
        (x ⋈_c W(j, c, chunk))                  (unnest(x) ⋈_d W__col(d, c,
    → π split j → (c, e) → collect               chunk))

    ROW_CHUNK (per-head)                    COL_CHUNK_HEADS
    --------------------                    ---------------
    γ_{(t,h,r), SUM(dot(v, chunk))}         γ_{(t,h,c), sumForEach(x·chunk)}
        (x ⋈_c W(h, r, c, chunk))               (unnest(x) ⋈_d W__colh(h, d,
    → π split r → (c, e) → collect               c, chunk))

The column plans join on the input feature ``d``, group by the *output
chunk* ``c`` (the head key ``h`` rides along as a block key) instead of
exploding the reduction key into the GROUP BY, and produce already-chunked
vectors — the ROW_CHUNK plan's re-chunk tail disappears.

Three planner stages run under one call:

1. **Site pricing** — every matmul site is priced under both layouts.
2. **Global residency pass** — instead of accepting every profitable
   rewrite independently, candidates are ranked by benefit per duplicate
   byte and accepted greedily while the *extra* residency the column copy
   costs (the row table stays resident for other pipelines / as the
   conversion source) fits ``budget_bytes``.  Under memory pressure the
   plan degrades per-layer (the best sites keep their column copies)
   instead of all-or-nothing.
3. **Cache planning** — KV-cache tables are re-keyed to the cost-chosen
   physical key order (``row_chunk`` / ``head_major`` / ``pos_major``,
   see :mod:`repro_torch.planner.layout`); all Scans share the schema by
   reference, so every consumer join follows.

Decisions, costs, and the table conversions they imply are returned as a
:class:`LayoutPlan`, which also knows how to materialise the transposed
tables into an executor environment (:meth:`ensure_env`) and how to emit
the SQL data-conversion script (:meth:`conversion_sql`).

Modes: ``"off"`` (no rewrites), ``"auto"`` (cost-based, the default knob
position), ``"col"`` (force the column layout wherever legal — used by
equivalence tests and ablations).  Cache modes: ``"off"`` (keep the seed
order), ``"auto"`` (cost-based), or a layout name to force.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, List, Optional

from repro_torch.core import relational as ra
from repro_torch.core.opmap import RelPipeline
from repro_torch.core.relational import (
    Collect, GroupAgg, Join, Project, RelNode, RelSchema, Scan, Unnest, add,
    col, const, floordiv, key, mod, mul,
)
from repro_torch.planner import cost as cost_mod
from repro_torch.planner.cost import CostParams
from repro_torch.planner.layout import (
    CACHE_LAYOUTS, CACHE_ROW_CHUNK, COL_CHUNK, COL_CHUNK_HEADS, ROW_CHUNK,
    MatmulSite, cache_schema, col_schema, colh_schema, match_cache_sites,
    match_matmul_site,
)

MODES = ("off", "auto", "col")
CACHE_MODES = ("off", "auto") + CACHE_LAYOUTS
CHUNK_MODES = ("off", "auto")
# precision planning: "off" keeps f32 payloads, "auto" is cost/budget-based,
# or force a codec everywhere it is legal
PRECISION_MODES = ("off", "auto", "int8", "nf4")


@dataclasses.dataclass
class ResidencyPool:
    """Shared residency budget across pipelines (ROADMAP "residency budget
    across pipelines").

    The serving engine plans its decode and prefill pipelines separately,
    but their column copies land in one physical environment — a column
    table admitted by one plan is *free* for every later plan (the copy is
    already resident), and new copies from all plans draw on the same
    ``budget_bytes``.  The pool also remembers each committed table's
    chunk size; later plans sharing the pool are pinned to it
    (``plan_layouts`` folds ``chunks`` into its forced per-table sizes),
    so two pipelines can never declare different physical widths for one
    shared table.  ``plan_layouts`` creates a throwaway single-plan pool
    when none is passed, which reproduces the old per-pipeline
    accounting.
    """

    budget_bytes: Optional[int] = None
    spent: int = 0
    tables: Dict[str, int] = dataclasses.field(default_factory=dict)
    chunks: Dict[str, int] = dataclasses.field(default_factory=dict)
    # pinned payload precisions: stored table -> "f32" | codec name.  Like
    # ``chunks``, the first plan to decide a shared table's precision pins
    # it for every later plan on the pool — one physical table, one
    # payload format.
    precisions: Dict[str, str] = dataclasses.field(default_factory=dict)

    def admits(self, table: str, nbytes: int) -> bool:
        return (table in self.tables or self.budget_bytes is None
                or self.spent + nbytes <= self.budget_bytes)

    def admit(self, table: str, nbytes: int, chunk_size: int = 0) -> int:
        """Commit a column copy; returns the *new* bytes it costs (0 when
        an earlier plan already committed the same table)."""
        if table in self.tables:
            return 0
        self.tables[table] = nbytes
        if chunk_size:
            self.chunks[table] = chunk_size
        self.spent += nbytes
        return nbytes

    def requantise(self, table: str, nbytes: int) -> None:
        """Shrink (or grow) a committed copy's accounted bytes after a
        precision decision changed its stored payload format."""
        if table in self.tables:
            self.spent += nbytes - self.tables[table]
            self.tables[table] = nbytes


@dataclasses.dataclass(frozen=True)
class LayoutDecision:
    """One priced matmul site and the (layout, chunk_size) pair chosen for
    its weight table."""

    table: str
    col_table: str
    layout: str
    step_name: str
    in_features: int
    out_features: int       # per head block for head sites
    row_chunk: int
    col_chunk: int
    row_cost: float
    col_cost: float
    row_keys: tuple  # key names of the ROW_CHUNK schema ((j, c) or (h, r, c))
    vec_col: str
    row_schema: object = None  # RelSchema of the ROW_CHUNK source table
    head_key: Optional[str] = None  # set for COL_CHUNK_HEADS sites
    n_heads: int = 1
    weight_bytes: int = 0           # f32 bytes of the chosen physical copy
    denied_by_budget: bool = False  # col preferred but residency budget full
    chunk_size: int = 0             # planner-chosen physical chunk of the
    #                                 stored table (row table for ROW_CHUNK,
    #                                 column table otherwise)

    @property
    def is_head_site(self) -> bool:
        return self.head_key is not None

    @property
    def physical_chunk(self) -> int:
        """Chunk size of the stored table (falls back to the seed sizes)."""
        if self.chunk_size:
            return self.chunk_size
        return self.row_chunk if self.layout == ROW_CHUNK else self.col_chunk


@dataclasses.dataclass(frozen=True)
class CacheDecision:
    """One KV-cache table and the physical key order chosen for it."""

    table: str
    layout: str
    key_order: tuple               # physical key-name order after planning
    costs: dict = dataclasses.field(default_factory=dict)  # layout -> total
    chunk_size: int = 0            # physical chunk (tied to the pipeline)
    chunk_costs: dict = dataclasses.field(default_factory=dict)
    #                                (layout, chunk_size) -> total (priced
    #                                for the global chunk-size choice)


@dataclasses.dataclass(frozen=True)
class PrecisionDecision:
    """One stored weight table and the payload precision chosen for it.

    ``table`` is the f32 source (a row table, or a planner column copy);
    ``q_table`` its quantised twin the rewritten plan scans.  The chunk
    size doubles as the quantisation group size, so ``n_groups`` scales
    columns ride one per relational row.
    """

    table: str
    q_table: str
    precision: str               # codec name ("int8" | "nf4")
    chunk_size: int              # payload width == quantisation group size
    vec_col: str                 # f32 source's payload column name
    key_names: tuple
    schema: object               # RelSchema of the f32 source
    q_schema: object             # RelSchema of the quantised table
    n_elements: int              # payload elements (padding included)
    n_groups: int
    f32_bytes: int
    q_bytes: int
    costs: dict = dataclasses.field(default_factory=dict)
    #                              precision -> priced per-invocation total
    budget_driven: bool = False  # quantised to fit the residency budget
    #                              (auto mode), not by raw cost preference


@dataclasses.dataclass
class LayoutPlan:
    """Outcome of layout planning over one pipeline."""

    mode: str
    decisions: List[LayoutDecision] = dataclasses.field(default_factory=list)
    cache_decisions: List[CacheDecision] = dataclasses.field(
        default_factory=list)
    precision_decisions: List[PrecisionDecision] = dataclasses.field(
        default_factory=list)
    budget_bytes: Optional[int] = None   # residency budget the pass ran under
    residency_bytes: int = 0             # duplicate bytes the plan commits

    @property
    def col_decisions(self) -> List[LayoutDecision]:
        return [d for d in self.decisions
                if d.layout in (COL_CHUNK, COL_CHUNK_HEADS)]

    def layout_of(self, table: str) -> str:
        for d in self.decisions:
            if d.table == table:
                return d.layout
        return ROW_CHUNK

    def cache_layout_of(self, table: str) -> str:
        for d in self.cache_decisions:
            if d.table == table:
                return d.layout
        return CACHE_ROW_CHUNK

    def precision_of(self, table: str) -> str:
        """Stored payload precision of a (source) weight table."""
        for d in self.precision_decisions:
            if d.table == table:
                return d.precision
        return "f32"

    def ensure_env(self, env):
        """Materialise planned physical layouts into an executor environment.

        COL_CHUNK / COL_CHUNK_HEADS weight tables are transposed from their
        resident row-layout twins on first use; cache tables already present
        in ``env`` with a different key order are permuted in place (fresh
        caches should be created directly in the planned layout —
        ``llama_graph.empty_cache_tables(layout=...)``).  Row-layout weight
        tables stay untouched (other pipelines over the same environment may
        still scan them).  Environments that resolve layouts themselves
        (e.g. the paged ``LazyEnv``) are left alone for weights but still
        get their cache tables aligned.
        """
        from repro_torch.core import relational as ra
        from repro_torch.core.executor import (permute_table_keys,
                                         rechunk_chunked_table,
                                         transpose_chunked_table,
                                         transpose_head_chunked_table)
        if not getattr(env, "resolves_layouts", False):
            for d in self.decisions:
                # planner-re-chunked ROW tables: replace the stored copy
                if (d.layout == ROW_CHUNK and d.chunk_size
                        and d.chunk_size != d.row_chunk):
                    tbl = env.get(d.table) if hasattr(env, "get") else None
                    if tbl is None:
                        continue
                    vec_col = next(iter(tbl.cols))
                    if ra.vec_width(tbl.col_types[vec_col]) != d.chunk_size:
                        env[d.table] = rechunk_chunked_table(tbl,
                                                             d.chunk_size)
            for d in self.col_decisions:
                if d.col_table in env:
                    continue
                if d.is_head_site:
                    env[d.col_table] = transpose_head_chunked_table(
                        env[d.table], d.physical_chunk)
                else:
                    env[d.col_table] = transpose_chunked_table(
                        env[d.table], d.physical_chunk)
            # quantised payloads: materialise each quantised twin from its
            # resident f32 source (row table, or the column copy built
            # just above) — the executor-side §3.1 quantisation conversion
            for pd in self.precision_decisions:
                if pd.q_table in env:
                    continue
                from repro_torch.quant.codecs import CODECS, quantise_chunked_table
                env[pd.q_table] = quantise_chunked_table(
                    env[pd.table], CODECS[pd.precision])
        for cd in self.cache_decisions:
            tbl = env.get(cd.table) if hasattr(env, "get") else None
            if tbl is not None and tbl.key_names != cd.key_order:
                env[cd.table] = permute_table_keys(tbl, cd.key_order)
        return env

    def conversion_sql(self, dialect: str = "duckdb") -> str:
        """SQL data-conversion script: row tables → column tables (§3.1
        conversion re-run under the new physical layout), then f32 tables →
        quantised twins (which may read the column copies, so quantisation
        comes second).  Must run *after* the row tables are populated —
        ``CREATE OR REPLACE TABLE ... AS`` both creates and fills each
        table."""
        parts = [conversion_sql(self.col_decisions, dialect)]
        if self.precision_decisions:
            from repro_torch.quant.sql import quant_conversion_sql
            parts.append(quant_conversion_sql(self.precision_decisions,
                                              dialect))
        return "\n\n".join(p for p in parts if p)


def conversion_sql(decisions, dialect: str = "duckdb") -> str:
    """ROW2COL conversion statements for a set of column-layout decisions.

    Two-key sites transpose ``(j, c)`` → ``(d, c')``; head sites carry the
    head block key through: ``(h, r, c)`` → ``(h, d, c')``.
    """
    assert dialect in ("duckdb", "ansi")
    stmts = []
    for d in decisions:
        head = d.row_keys[:-2]            # () or (h,)
        jk, ck = d.row_keys[-2:]          # row key folded + chunk key
        cs_in, cs_out = d.row_chunk, d.physical_chunk
        hsel = "".join(f"{h}, " for h in head)
        if dialect == "duckdb":
            flat = (f"SELECT {hsel}{jk}, {ck} * {cs_in} + e.e AS d, "
                    f"{d.vec_col}[e.e + 1] AS x FROM {d.table}, "
                    f"(SELECT UNNEST(range({cs_in})) AS e) AS e")
            intdiv = "//"
        else:
            flat = (f"SELECT {hsel}{jk}, {ck} * {cs_in} + u.ord - 1 AS d, "
                    f"u.x AS x FROM {d.table}, "
                    f"UNNEST({d.vec_col}) WITH ORDINALITY AS u(x, ord)")
            intdiv = "/"
        tag = "ROW2COL (head-blocked)" if d.is_head_site else "ROW2COL"
        stmts.append(
            f"-- {tag}: {d.table} -> {d.col_table}\n"
            f"CREATE OR REPLACE TABLE {d.col_table} AS\n"
            f"WITH flat AS ({flat})\n"
            f"SELECT {hsel}d, {jk} {intdiv} {cs_out} AS c, "
            f"collect_as_array(LIST({jk} % {cs_out}), LIST(x)) "
            f"AS {d.vec_col}\n"
            f"FROM flat GROUP BY {hsel}d, {jk} {intdiv} {cs_out};")
    return "\n\n".join(stmts)


def union_conversion_sql(pipelines, dialect: str = "duckdb") -> str:
    """One conversion script covering several planned pipelines (e.g.
    prefill + decode, which are planned independently), deduplicated by
    column / quantised table.  ROW2COL conversions come first — a
    quantised column copy reads the converted column table."""
    seen, fresh = set(), []
    qseen, qfresh = set(), []
    for pipe in pipelines:
        plan = getattr(pipe, "layout_plan", None)
        if plan is None:
            continue
        for d in plan.col_decisions:
            if d.col_table not in seen:
                seen.add(d.col_table)
                fresh.append(d)
        for pd in plan.precision_decisions:
            if pd.q_table not in qseen:
                qseen.add(pd.q_table)
                qfresh.append(pd)
    parts = [conversion_sql(fresh, dialect)]
    if qfresh:
        from repro_torch.quant.sql import quant_conversion_sql
        parts.append(quant_conversion_sql(qfresh, dialect))
    return "\n\n".join(p for p in parts if p)


# ---------------------------------------------------------------------------
# Rewrite
# ---------------------------------------------------------------------------


def _fresh(name: str, taken) -> str:
    while name in taken:
        name += "_"
    return name


def _build_col_plan(site: MatmulSite,
                    chunk_size: Optional[int] = None) -> RelNode:
    """Construct the column-layout plan for a matched matmul site.

    Output schema is identical to the ROW_CHUNK plan's (same keys, same
    chunked vector column), so downstream consumers are unaffected.  For
    head sites the transposed table keeps the head block key and the GROUP
    BY is ``(…, h, c)``.

    ``chunk_size`` sets the transposed table's physical output chunking;
    when it differs from the consumer chunking (``site.col_chunk``) the
    already-chunked aggregate output is re-chunked back via an
    UNNEST + key merge/split + collect tail (priced by the cost model's
    ``rechunk_*`` terms).
    """
    csp = chunk_size or site.col_chunk
    base = site.base_keys
    xs_keys = {k for k, _ in base} | {site.join.on[0][1].name}
    if site.head_key:
        xs_keys.add(site.head_key)
    e_name = _fresh("e", xs_keys)
    d_name = _fresh("d", xs_keys)
    c_in = site.join.on[0][1].name  # activation chunk key
    cs_in = site.row_chunk
    out_chunk_key = site.rechunk_proj.keys[-2][0]  # usually "c"

    u = Unnest(input=site.x_plan, vec_col=site.x_col, elem_key=e_name,
               elem_col="x")
    p = Project(
        input=u,
        keys=[(k, s, key(k)) for k, s in base]
        + [(d_name, site.in_features,
            add(mul(key(c_in), const(cs_in)), key(e_name)))],
        exprs=[("xs", None, col("x"))],
    )
    if site.is_head_site:
        schema = colh_schema(site.n_heads, site.in_features,
                             site.out_features, csp,
                             head_key=site.head_key, d_key="d",
                             chunk_key=out_chunk_key)
        group_tail = [site.head_key, out_chunk_key]
    else:
        schema = col_schema(site.in_features, site.n_heads
                            * site.out_features, csp, d_key="d",
                            chunk_key=out_chunk_key)
        group_tail = [out_chunk_key]
    scan = Scan(table=site.col_table, table_schema=schema)
    j = Join(left=p, right=scan, on=[("d", key(d_name))])
    agg = GroupAgg(
        input=j,
        group_keys=[k for k, _ in base] + group_tail,
        aggs=[(site.out_col, "SUM", mul(col("xs"), col("chunk")))],
    )
    if csp == site.col_chunk:
        return agg
    return _rechunk_tail(agg, site, csp)


def _rechunk_adapter(plan: RelNode, lead_keys, chunk_key: str, width: int,
                     from_cs: int, to_cs: int, vec_col: str,
                     merged_key: str = "d") -> RelNode:
    """UNNEST → key-merge π → key-split π → collect: re-chunk ``plan``'s
    ``(…, chunk_key, vec[from_cs])`` relation to ``vec[to_cs]`` over the
    same ``width``-wide folded dimension.  The shared shape behind both
    chunk-size adapters (activation re-chunk before a ROW join, output
    tail after a column aggregate)."""
    lead_keys = list(lead_keys)
    taken = {k for k, _ in lead_keys} | {chunk_key}
    e_name = _fresh("e", taken)
    d_name = _fresh(merged_key, taken)
    u = Unnest(input=plan, vec_col=vec_col, elem_key=e_name, elem_col="x")
    merge = Project(
        input=u,
        keys=[(k, s, key(k)) for k, s in lead_keys]
        + [(d_name, width,
            add(mul(key(chunk_key), const(from_cs)), key(e_name)))],
        exprs=[("x", None, col("x"))],
    )
    split = Project(
        input=merge,
        keys=[(k, s, key(k)) for k, s in lead_keys]
        + [(chunk_key, width // to_cs, floordiv(key(d_name), const(to_cs))),
           (e_name, to_cs, mod(key(d_name), const(to_cs)))],
        exprs=[("x", None, col("x"))],
    )
    return Collect(input=split, fold_key=e_name, scalar_col="x",
                   vec_col=vec_col)


def _rechunk_tail(agg: RelNode, site: MatmulSite, csp: int) -> RelNode:
    """Re-chunk a column plan's ``(…, c'∈[m/cs'], vec[cs'])`` output back to
    the consumer chunking ``(…, c∈[m/cs_out], vec[cs_out])``."""
    out_chunk_key = site.rechunk_proj.keys[-2][0]
    head = [(site.head_key, site.n_heads)] if site.is_head_site else []
    return _rechunk_adapter(
        agg, list(site.base_keys) + head, out_chunk_key,
        width=site.out_features,  # per head block for head sites
        from_cs=csp, to_cs=site.col_chunk, vec_col=site.out_col,
        merged_key="r")


def _build_rechunked_row_plan(site: MatmulSite, cs_w: int) -> RelNode:
    """ROW_CHUNK plan against a weight table stored at chunk ``cs_w``
    (≠ the pipeline's activation chunking): the activation is re-chunked
    to ``cs_w`` before the join (UNNEST + key merge/split + collect), the
    weight Scan reads the ``cs_w``-chunked schema, and the aggregate /
    re-chunk-to-output tail are rebuilt unchanged."""
    c_in = site.join.on[0][1].name          # activation chunk key name
    ws = site.weight_scan.table_schema
    cname = ws.keys[-1][0]                  # weight chunk key name
    wcol, _ = ws.cols[0]
    n = site.in_features
    x2 = _rechunk_adapter(site.x_plan, site.base_keys, c_in, width=n,
                          from_cs=site.row_chunk, to_cs=cs_w,
                          vec_col=site.x_col)
    wschema = RelSchema(keys=ws.keys[:-1] + ((cname, n // cs_w),),
                        cols=((wcol, ra.VEC(cs_w)),))
    scan = Scan(table=site.table, table_schema=wschema)
    j = Join(left=x2, right=scan, on=[(cname, key(c_in))])
    agg = GroupAgg(input=j, group_keys=list(site.agg.group_keys),
                   aggs=list(site.agg.aggs))
    proj = Project(input=agg, keys=list(site.rechunk_proj.keys),
                   exprs=list(site.rechunk_proj.exprs))
    return Collect(input=proj, fold_key=site.root.fold_key,
                   scalar_col=site.root.scalar_col,
                   vec_col=site.root.vec_col)


def _replace_nodes(pipeline: RelPipeline, mapping: Dict[int, RelNode]):
    """Swap rewritten plan roots everywhere they appear (plans are shared
    DAGs: downstream steps embed upstream bind roots by reference)."""
    seen = set()

    def fix(node: RelNode):
        if id(node) in seen:
            return
        seen.add(id(node))
        if isinstance(node, Scan):
            return
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, RelNode):
                nv = mapping.get(id(v), v)
                if nv is not v:
                    setattr(node, f.name, nv)
                fix(nv)

    def fix_rel(rel):
        rel.plan = mapping.get(id(rel.plan), rel.plan)
        fix(rel.plan)

    for step in pipeline.steps:
        fix_rel(step.rel)
    for rel in pipeline.bindings.values():
        fix_rel(rel)


def _decision_for(site: MatmulSite, layout: str, row_cost: float,
                  col_cost: float, denied: bool = False,
                  chunk_size: int = 0,
                  weight_bytes: Optional[int] = None,
                  stored_row_chunk: int = 0) -> LayoutDecision:
    ws = site.weight_scan.table_schema
    row_chunk, row_schema = site.row_chunk, ws
    if stored_row_chunk and stored_row_chunk != site.row_chunk:
        # the shared row source is physically stored at a pool-pinned width
        # (an earlier plan re-chunked it): the conversion SQL must read it
        # at that width, not at this pipeline's activation chunking
        row_chunk = stored_row_chunk
        nch = max(1, math.ceil(site.in_features / stored_row_chunk))
        row_schema = RelSchema(
            keys=ws.keys[:-1] + ((ws.keys[-1][0], nch),),
            cols=((ws.cols[0][0], ra.VEC(stored_row_chunk)),))
    return LayoutDecision(
        table=site.table,
        col_table=site.col_table,
        layout=layout,
        step_name=site.step_name,
        in_features=site.in_features,
        out_features=site.out_features,
        row_chunk=row_chunk,
        col_chunk=site.col_chunk,
        row_cost=row_cost,
        col_cost=col_cost,
        row_keys=tuple(k for k, _ in ws.keys),
        vec_col=ws.cols[0][0],
        row_schema=row_schema,
        head_key=site.head_key,
        n_heads=site.n_heads,
        weight_bytes=(site.weight_bytes if weight_bytes is None
                      else weight_bytes),
        denied_by_budget=denied,
        chunk_size=chunk_size,
    )


def plan_layouts(pipeline: RelPipeline, mode: str = "auto",
                 params: Optional[CostParams] = None,
                 budget_bytes: Optional[int] = None,
                 cache_mode: str = "off",
                 chunk_mode: str = "off",
                 chunk_candidates=None,
                 table_chunks: Optional[Dict[str, int]] = None,
                 pool: Optional[ResidencyPool] = None,
                 precision_mode: str = "off",
                 table_precisions: Optional[Dict[str, str]] = None,
                 shards: Optional[int] = None
                 ) -> LayoutPlan:
    """Run the layout planner over a compiled pipeline (in place).

    ``budget_bytes`` bounds the *duplicate* residency column copies add on
    top of the always-resident row tables (the pager working-set budget);
    ``None`` means unbounded.  Pass ``pool`` (a :class:`ResidencyPool`)
    instead to share one budget across several pipelines — copies an
    earlier plan already committed are free here, and new copies draw on
    the shared budget.  ``cache_mode`` re-keys the KV-cache tables:
    ``"off"`` keeps the seed order, ``"auto"`` is cost-based, or pass a
    layout name (``"row_chunk"`` / ``"head_major"`` / ``"pos_major"``) to
    force one — every pipeline sharing a session environment must agree on
    the cache layout (the serving engine forces its prefill pipelines to
    the decode choice).

    ``chunk_mode="auto"`` additionally makes the physical chunk size of
    every weight table a planner decision: sites are priced over
    ``chunk_candidates`` (default :data:`~repro_torch.planner.cost.
    CHUNK_CANDIDATES`) jointly with layout, the residency pass admits
    (layout, chunk_size) pairs by benefit per byte, and winning tables are
    rewritten with re-chunk adapters where the stored chunking differs
    from the pipeline's.  ``table_chunks`` forces per-table sizes (the
    serving engine pins its prefill plans to the decode plan's choices —
    both pipelines scan the same physical tables).  Chosen sizes are
    recorded on ``pipeline.table_chunks``.

    ``precision_mode`` makes the stored payload *precision* a planner
    decision on top of (layout, chunk_size): ``"off"`` keeps f32,
    ``"int8"``/``"nf4"`` force a codec on every eligible table, and
    ``"auto"`` is cost-based — quantised payloads shrink the per-
    invocation byte traffic (``CostParams.byte_weight``) but pay a
    per-element dequant term (``dequant_weight``), and when the pool
    carries a budget the f32 tables exceed, tables are quantised greedily
    by bytes saved until the working set fits (the residency pass
    admitting precision by benefit per byte).  Winning tables are
    rewritten in place: every Scan of the stored table becomes an inline
    dequant projection over its quantised twin.  ``table_precisions``
    forces per-table choices (keyed by the stored or the source row name;
    ``"f32"`` exempts a table).  Chosen codecs are recorded on
    ``pipeline.table_precisions`` and pinned on the pool for later plans.

    ``shards=N`` (N > 1) additionally runs the sharded-execution pass
    (:mod:`repro_torch.planner.shard`) over the *final* physical plans: each
    eligible weight table's column/head-chunk key space is partitioned
    into N contiguous ranges and per-shard plan copies plus a combine
    decision are recorded on ``pipeline.shard_plan`` — without rewriting
    the pipeline, so ``shards=None``/``1`` is a strict no-op.

    Returns the :class:`LayoutPlan`; also records it on
    ``pipeline.layout_plan`` and the per-table choices on
    ``pipeline.layouts`` so downstream stages (``run_pipeline``,
    ``sqlgen``) can act on it without re-planning.
    """
    if mode not in MODES:
        raise ValueError(f"layout mode {mode!r} not in {MODES}")
    if cache_mode not in CACHE_MODES:
        raise ValueError(f"cache mode {cache_mode!r} not in {CACHE_MODES}")
    if chunk_mode not in CHUNK_MODES:
        raise ValueError(f"chunk mode {chunk_mode!r} not in {CHUNK_MODES}")
    if chunk_mode == "auto" and mode == "off":
        raise ValueError("chunk_mode='auto' requires layout planning "
                         "(mode 'auto' or 'col')")
    if precision_mode not in PRECISION_MODES:
        raise ValueError(
            f"precision mode {precision_mode!r} not in {PRECISION_MODES}")
    if pool is None:
        pool = ResidencyPool(budget_bytes=budget_bytes)
    plan = LayoutPlan(mode=mode, budget_bytes=pool.budget_bytes)
    if mode != "off":
        # tables an earlier plan committed through a shared pool are pinned
        # to their committed chunk size (one physical table, one width);
        # explicit table_chunks take precedence
        forced = dict(pool.chunks)
        forced.update(table_chunks or {})
        _plan_weight_layouts(pipeline, plan, mode, params, pool,
                             chunk_mode, chunk_candidates, forced)
    if precision_mode != "off":
        _plan_precisions(pipeline, plan, precision_mode, params, pool,
                         table_precisions or {})
    if cache_mode != "off":
        _plan_cache_layouts(pipeline, plan, cache_mode, params,
                            chunk_mode, chunk_candidates)
    if shards and int(shards) > 1:
        # sharding runs LAST: the sites it matches (and the per-shard plan
        # copies it builds) must see the final physical plans — column
        # rewrites, re-chunked tables and inline dequant projections
        # included.  It never rewrites the pipeline itself, so shards=None
        # (or 1) leaves plans and SQL bit-identical.
        from repro_torch.planner.shard import plan_shards
        plan_shards(pipeline, int(shards), params=params)
    else:
        pipeline.shard_plan = None
    pipeline.layout_plan = plan
    return plan


def _site_options(site: MatmulSite, p: CostParams, chunk_mode: str,
                  chunk_candidates, forced: Dict[str, int]):
    """Best (chunk_size, total) per layout for one site.

    With ``chunk_mode="off"`` the candidate sets collapse to the seed
    sizes, reproducing the fixed-chunk planner exactly.  Forced per-table
    sizes (``forced``) override the candidate set for that table.
    """
    cands = tuple(chunk_candidates or cost_mod.CHUNK_CANDIDATES) \
        if chunk_mode == "auto" else ()
    row_costs, col_costs = cost_mod.site_chunk_costs(site, p, cands)
    if site.table in forced:
        # a forced size outside the candidate grid is priced directly; it
        # only has to be legal (pad-free) for the chunked dimension
        cs = forced[site.table]
        if site.in_features % cs != 0:
            raise ValueError(
                f"forced chunk size {cs} for {site.table!r} does not "
                f"divide its input dimension {site.in_features}")
        row_costs = {cs: row_costs.get(cs) or cost_mod.row_chunk_cost(
            p.seq_len, site.in_features,
            site.n_heads * site.out_features, cs,
            act_chunk=site.row_chunk)}
    if site.col_table in forced:
        cs = forced[site.col_table]
        if site.out_features % cs != 0:
            raise ValueError(
                f"forced chunk size {cs} for {site.col_table!r} does not "
                f"divide its output dimension {site.out_features}")
        if cs not in col_costs:
            if site.is_head_site:
                c = cost_mod.colh_chunk_cost(
                    p.seq_len, site.n_heads, site.in_features,
                    site.out_features, cs, out_chunk=site.col_chunk)
            else:
                c = cost_mod.col_chunk_cost(
                    p.seq_len, site.in_features,
                    site.n_heads * site.out_features, cs,
                    out_chunk=site.col_chunk)
            col_costs[cs] = c
        col_costs = {cs: col_costs[cs]}
    row_cs, row_cost = cost_mod.best_chunk(row_costs, p, site.row_chunk)
    col_cs, col_cost = cost_mod.best_chunk(col_costs, p, site.col_chunk)
    return row_cs, row_cost, col_cs, col_cost


def _col_bytes(site: MatmulSite, cs: int) -> int:
    """f32 bytes of the column copy chunked at ``cs`` along the *output*
    dimension (padding included — non-divisor sizes pay for their tail)."""
    nch = max(1, math.ceil(site.out_features / cs))
    return 4 * site.n_heads * site.in_features * nch * cs


def _row_bytes(site: MatmulSite, cs: int) -> int:
    """f32 bytes of the row table chunked at ``cs`` along the *input*
    dimension (padding included)."""
    nch = max(1, math.ceil(site.in_features / cs))
    return 4 * site.n_heads * site.out_features * nch * cs


def _plan_weight_layouts(pipeline: RelPipeline, plan: LayoutPlan, mode: str,
                         params: Optional[CostParams],
                         pool: ResidencyPool, chunk_mode: str,
                         chunk_candidates,
                         forced: Dict[str, int]) -> None:
    sites: List[MatmulSite] = []
    for step in pipeline.steps:
        if step.kind != "bind":
            continue
        site = match_matmul_site(step.name, step.rel.plan)
        if site is not None:
            sites.append(site)

    # -- stage 1: price every site's (layout, chunk_size) options.  A
    # calibrated ``params`` supplies the weights; the per-site seq-len is
    # structural and always derived from the site.
    priced = []
    for site in sites:
        if params is not None:
            p = dataclasses.replace(params, seq_len=site.seq_len)
        else:
            p = CostParams(seq_len=site.seq_len)
        row_cs, row_cost, col_cs, col_cost = _site_options(
            site, p, chunk_mode, chunk_candidates, forced)
        wants_col = (mode == "col") or col_cost < row_cost
        priced.append((site, row_cs, row_cost, col_cs, col_cost, wants_col))

    # -- stage 2: global residency pass.  Column copies are *extra* bytes on
    # top of the row tables (which remain the conversion source / serve
    # other pipelines), so rank candidates by benefit per duplicate byte and
    # admit greedily within the budget — under pressure the plan keeps the
    # most profitable layers' column copies and degrades the rest to
    # ROW_CHUNK instead of flipping the whole model.  The pool may be
    # shared across pipelines: already-committed tables are free.
    candidates = [(s, rc, cc, ccs) for s, rcs, rc, ccs, cc, w in priced if w]
    candidates.sort(
        key=lambda t: (t[1] - t[2]) / max(_col_bytes(t[0], t[3]), 1),
        reverse=True)
    admitted: Dict[int, bool] = {}
    spent = 0
    for site, rc, cc, ccs in candidates:
        nb = _col_bytes(site, ccs)
        if not pool.admits(site.col_table, nb):
            admitted[id(site)] = False
            continue
        spent += pool.admit(site.col_table, nb, chunk_size=ccs)
        admitted[id(site)] = True
    plan.residency_bytes = spent

    mapping: Dict[int, RelNode] = {}
    for site, row_cs, row_cost, col_cs, col_cost, wants_col in priced:
        take_col = wants_col and admitted.get(id(site), False)
        layout = site.col_layout if take_col else ROW_CHUNK
        chunk = col_cs if take_col else row_cs
        # pin the shared *row* table's physical width for later plans on
        # the same pool: scanned row tables at the chosen size, conversion
        # sources at the seed chunking (one physical table, one width)
        pool.chunks.setdefault(site.table,
                               site.row_chunk if take_col else row_cs)
        decision = _decision_for(
            site, layout, row_cost, col_cost,
            denied=wants_col and not take_col, chunk_size=chunk,
            weight_bytes=(_col_bytes(site, col_cs) if take_col
                          else _row_bytes(site, row_cs)),
            stored_row_chunk=(pool.chunks[site.table] if take_col else 0))
        plan.decisions.append(decision)
        if not take_col:
            pipeline.layouts[site.table] = ROW_CHUNK
            if row_cs != site.row_chunk:
                # planner re-chunks the stored row table: rewrite the plan
                # with the activation re-chunk adapter and re-declare the
                # table's physical schema
                new_root = _build_rechunked_row_plan(site, row_cs)
                mapping[id(site.root)] = new_root
                pipeline.weight_schemas[site.table] = _root_weight_schema(
                    new_root, site.table)
                pipeline.table_chunks[site.table] = row_cs
            continue
        new_root = _build_col_plan(site, col_cs)
        mapping[id(site.root)] = new_root
        # the pipeline now scans the transposed table instead
        pipeline.weight_schemas.pop(site.table, None)
        pipeline.weight_schemas[decision.col_table] = _root_weight_schema(
            new_root, site.col_table)
        pipeline.layouts[decision.col_table] = layout
        if chunk_mode == "auto" or site.col_table in forced:
            pipeline.table_chunks[site.col_table] = col_cs

    if mapping:
        _replace_nodes(pipeline, mapping)


# ---------------------------------------------------------------------------
# Precision planning — quantised chunk payloads (ISSUE 5)
# ---------------------------------------------------------------------------


def _precision_candidates(pipeline: RelPipeline, plan: LayoutPlan):
    """Stored weight tables eligible for quantisation, in deterministic
    (step) order: ``{stored_table: (schema, source_row_name)}``.

    With layout planning on, the stored tables come from the layout
    decisions (the column copy where the site was rewritten, the row table
    otherwise); with layout planning off, matmul sites are matched
    directly.  Embedding-style value-join tables (``vocabulary``) are
    eligible either way; norm vectors and input tables are not.
    """
    from repro_torch.planner.layout import match_value_join_tables
    out: Dict[str, tuple] = {}
    if plan.decisions:
        for d in plan.decisions:
            stored = d.table if d.layout == ROW_CHUNK else d.col_table
            schema = pipeline.weight_schemas.get(stored)
            if schema is not None:
                out.setdefault(stored, (schema, d.table))
    else:
        for step in pipeline.steps:
            if step.kind != "bind":
                continue
            site = match_matmul_site(step.name, step.rel.plan)
            if site is not None:
                out.setdefault(site.table,
                               (site.weight_scan.table_schema, site.table))
    for table, schema in match_value_join_tables(pipeline).items():
        out.setdefault(table, (schema, table))
    return out


def _scan_parents(pipeline: RelPipeline) -> Dict[str, list]:
    """table → [(node, field, scan)] for every field of a plan node (steps
    and bindings) that holds a Scan: one walk for all the tables a plan
    quantises, where a walk per table is quadratic in depth."""
    parents: Dict[str, list] = {}
    seen: set = set()
    stack = [step.rel.plan for step in pipeline.steps] + [
        rel.plan for rel in pipeline.bindings.values()]
    while stack:
        node = stack.pop()
        if id(node) in seen or isinstance(node, Scan):
            continue
        seen.add(id(node))
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, Scan):
                parents.setdefault(v.table, []).append((node, f.name, v))
            elif isinstance(v, RelNode):
                stack.append(v)
    return parents


def _rewrite_quant_scans(pipeline: RelPipeline, table: str, q_table: str,
                         codec, parents: Dict[str, list]) -> None:
    """Replace every Scan of ``table`` with the inline dequant projection
    over its quantised twin — the paper-idiomatic dequantise-in-the-
    projection rewrite.  The projection's output schema is identical to
    the f32 scan's (same keys, same vector column), so no consumer
    changes.  ``parents`` is ``_scan_parents(pipeline)``, taken before the
    first rewrite (a rewrite only swaps Scans of its own table)."""
    from repro_torch.quant.codecs import quant_schema
    wrapped: Dict[int, RelNode] = {}

    def make(scan: Scan) -> RelNode:
        if id(scan) not in wrapped:
            vec_col, vec_type = scan.table_schema.cols[0]
            wrapped[id(scan)] = Project(
                input=Scan(table=q_table,
                           table_schema=quant_schema(scan.table_schema)),
                keys=None,
                exprs=[(vec_col, vec_type, codec.dequant_expr())])
        return wrapped[id(scan)]

    for node, field, scan in parents.get(table, ()):
        setattr(node, field, make(scan))


def _plan_precisions(pipeline: RelPipeline, plan: LayoutPlan, mode: str,
                     params: Optional[CostParams], pool: ResidencyPool,
                     forced: Dict[str, str]) -> None:
    """Choose and apply a stored payload precision per weight table.

    Stage 1 prices every eligible table under every precision
    (:func:`repro_torch.planner.cost.precision_cost`: bytes streamed per
    invocation vs the per-element dequant term) and takes the per-table
    argmin (forced modes and per-table pins override).  Stage 2 — the
    residency pass — only runs in ``"auto"`` mode under a pool budget:
    while the stored weight set exceeds the budget, the table with the
    most bytes saved is flipped to int8, then (if still over) to nf4, so
    quantisation is admitted exactly where it buys the most bytes.  Stage
    3 rewrites every Scan of a quantised table into a dequant projection,
    re-declares the physical schema, and pins the choice on the pool so
    every later plan sharing the environment agrees.
    """
    from repro_torch.quant.codecs import (CODECS, PRECISIONS, precision_bytes,
                                    q_table_name)
    p = params or CostParams()
    cands = _precision_candidates(pipeline, plan)
    infos: Dict[str, dict] = {}
    for stored, (schema, source) in cands.items():
        vec_col, vec_type = schema.cols[0]
        cs = ra.vec_width(vec_type)
        n_groups = 1
        for _, s in schema.keys:
            n_groups *= s
        infos[stored] = dict(schema=schema, source=source, vec_col=vec_col,
                             cs=cs, n_groups=n_groups,
                             n_elements=n_groups * cs)

    # -- stage 1: per-table wanted precision
    chosen: Dict[str, str] = {}
    costs_by: Dict[str, dict] = {}
    pinned: set = set()
    for stored, info in infos.items():
        costs_by[stored] = cost_mod.precision_costs(
            info["n_elements"], info["n_groups"], p)
        pin = forced.get(stored, forced.get(info["source"]))
        if pin is None:
            pin = pool.precisions.get(stored)
        if pin is not None:
            if pin not in PRECISIONS:
                raise ValueError(
                    f"unknown precision {pin!r} for table {stored!r} "
                    f"(choose from {PRECISIONS})")
            chosen[stored] = pin
            pinned.add(stored)
        elif mode in CODECS:
            chosen[stored] = mode
        else:  # auto: cheapest precision (ties keep higher fidelity)
            chosen[stored], _ = cost_mod.choose_precision(
                info["n_elements"], info["n_groups"], p)

    # -- stage 2 (auto): residency pass.  The stored weight tables ARE the
    # pager working set; when their bytes exceed the pool budget, flip
    # the biggest tables to quantised payloads — greedily by bytes saved
    # (benefit per byte of budget reclaimed) — until the set fits.
    budget_driven: set = set()
    if mode == "auto" and pool.budget_bytes is not None:
        def tbytes(t: str) -> int:
            return precision_bytes(chosen[t], infos[t]["n_elements"],
                                   infos[t]["n_groups"])

        free = [t for t in infos if t not in pinned]
        for target in ("int8", "nf4"):
            while sum(tbytes(t) for t in infos) > pool.budget_bytes:
                flips = [(precision_bytes(chosen[t], infos[t]["n_elements"],
                                          infos[t]["n_groups"])
                          - precision_bytes(target, infos[t]["n_elements"],
                                            infos[t]["n_groups"]), t)
                         for t in free if chosen[t] != target]
                flips = [(gain, t) for gain, t in flips if gain > 0]
                if not flips:
                    break
                _, pick = max(flips)
                chosen[pick] = target
                budget_driven.add(pick)

    # -- stage 3: record, rewrite, pin
    parents = (_scan_parents(pipeline)
               if any(p != "f32" for p in chosen.values()) else {})
    for stored, info in infos.items():
        prec = chosen[stored]
        pool.precisions.setdefault(stored, prec)
        if prec == "f32":
            continue
        codec = CODECS[prec]
        from repro_torch.quant.codecs import quant_schema
        q_table = q_table_name(stored, prec)
        q_schema = quant_schema(info["schema"])
        q_bytes = precision_bytes(prec, info["n_elements"],
                                  info["n_groups"])
        plan.precision_decisions.append(PrecisionDecision(
            table=stored,
            q_table=q_table,
            precision=prec,
            chunk_size=info["cs"],
            vec_col=info["vec_col"],
            key_names=info["schema"].key_names,
            schema=info["schema"],
            q_schema=q_schema,
            n_elements=info["n_elements"],
            n_groups=info["n_groups"],
            f32_bytes=4 * info["n_elements"],
            q_bytes=q_bytes,
            costs=costs_by[stored],
            budget_driven=stored in budget_driven,
        ))
        _rewrite_quant_scans(pipeline, stored, q_table, codec, parents)
        # the pipeline now scans the quantised twin; the f32 source DDL
        # survives through the decision (conversion input), mirroring the
        # ROW2COL source-table convention
        pipeline.weight_schemas.pop(stored, None)
        pipeline.weight_schemas[q_table] = q_schema
        pipeline.table_precisions[q_table] = prec
        if stored in pipeline.table_chunks:
            pipeline.table_chunks[q_table] = pipeline.table_chunks[stored]
        if stored in pipeline.layouts:
            pipeline.layouts[q_table] = pipeline.layouts[stored]
        # a committed column copy now stores quantised bytes — shrink the
        # pool accounting (and this plan's, when it committed the copy)
        if stored in pool.tables:
            if any(d.col_table == stored for d in plan.col_decisions):
                plan.residency_bytes -= pool.tables[stored] - q_bytes
            pool.requantise(stored, q_bytes)


def _root_weight_schema(root: RelNode, table: str):
    """Schema of the named weight Scan inside a rewritten plan root.  A
    weight table is scanned at its one site, a few nodes below the root:
    a breadth-first search finds it there, where the reference's full walk
    crosses every upstream layer (quadratic over a pipeline's sites)."""
    queue, seen = collections.deque([root]), {id(root)}
    while queue:
        node = queue.popleft()
        if isinstance(node, Scan):
            if node.table == table:
                return node.table_schema
            continue
        for f in dataclasses.fields(node):
            kid = getattr(node, f.name)
            if isinstance(kid, RelNode) and id(kid) not in seen:
                seen.add(id(kid))
                queue.append(kid)
    raise AssertionError(table)


def _plan_cache_layouts(pipeline: RelPipeline, plan: LayoutPlan,
                        cache_mode: str,
                        params: Optional[CostParams],
                        chunk_mode: str = "off",
                        chunk_candidates=None) -> None:
    """Pick and apply a physical key order for every KV-cache table.

    The rewrite is purely physical: every Scan of the cache shares its
    schema, and all consumer joins/aggregates bind cache keys by *name*,
    so permuting the key order changes the stored array axis order (and
    the SQL DDL column order) without touching plan semantics.

    A cache table's chunk size stays tied to the pipeline chunking (the
    append path and both attention joins share it with Q/K/V); under
    ``chunk_mode="auto"`` the candidate chunk sizes are *priced* and
    recorded on the decision, informing the global chunk-size choice.
    """
    for site in match_cache_sites(pipeline):
        p = params or CostParams(seq_len=1)
        costs = cost_mod.cache_site_costs(site, p)
        if cache_mode == "auto":
            layout = cost_mod.choose_cache_layout(site, p, costs=costs)
        else:
            layout = cache_mode
        chunk_costs = {}
        if chunk_mode == "auto":
            chunk_costs = cost_mod.cache_chunk_costs(
                site, p, tuple(chunk_candidates
                               or cost_mod.CHUNK_CANDIDATES))
        new_schema = cache_schema(site.seed_schema, layout)
        for scan in site.scans:
            scan.table_schema = new_schema
            scan.schema = new_schema
        pipeline.input_schemas[site.table] = new_schema
        pipeline.layouts[site.table] = layout
        plan.cache_decisions.append(CacheDecision(
            table=site.table, layout=layout,
            key_order=new_schema.key_names, costs=costs,
            chunk_size=site.chunk, chunk_costs=chunk_costs))
