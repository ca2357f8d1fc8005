"""Physical-layout IR for weight and cache tables (the planner's vocabulary).

Weight layouts
--------------
A chunked weight matrix ``W ∈ R^{m×n}`` admits two physical layouts:

  ROW_CHUNK  — the seed layout: table ``W(j, c, chunk FLOAT[cs])`` with
               ``j ∈ [m)`` indexing output rows and ``c`` chunking the
               *input* dimension; data array ``[m, n/cs, cs]``.  A matmul
               joins on the input-chunk key ``c`` and groups by the output
               row ``j`` (exploding the reduction key into the GROUP BY).
  COL_CHUNK  — the paper's ROW2COL layout: transposed table
               ``W__col(d, c, chunk FLOAT[cs'])`` with ``d ∈ [n)`` indexing
               input features and ``c`` chunking the *output* dimension;
               data array ``[n, m/cs', cs']``.  A matmul joins on the input
               feature ``d`` and groups by the output chunk ``c`` — the
               aggregate is an elementwise vector SUM (``sumForEach``) whose
               result is already chunked, so the ROW_CHUNK plan's re-chunk
               tail (π key-split + collect_as_array) disappears.

Per-head projection weights ``W(h, r, c, chunk)`` (the ``map_linear_heads``
shape — Q/K/V) additionally admit

  COL_CHUNK_HEADS — the head-blocked column layout: ``W__colh(h, d, c,
               chunk FLOAT[cs'])`` with the head key ``h`` carried through as
               a *block* key, ``d ∈ [n)`` indexing input features and ``c``
               chunking the per-head output (head_dim).  The re-chunk of the
               ROW_CHUNK plan folds the per-head row key ``r``; the
               head-blocked layout keeps ``h`` outside the fold, so the
               column rewrite (join on ``d``, group by ``(h, c)``, vector
               SUM) stays legal.  Data array ``[H, n, dh/cs', cs']``.

Legality (encoded by :func:`admissible_layouts`): COL_CHUNK applies to the
canonical two-key matmul weights (``map_linear``); COL_CHUNK_HEADS to the
three-key per-head weights (``map_linear_heads``).  Value joins (embedding
lookups) and norm vectors are not matmuls and keep ROW_CHUNK.

Cache layouts
-------------
KV-cache tables (``k_cache_L*``/``v_cache_L*``) are planner-managed too.  A
cache layout descriptor is a named permutation of the cache's key order —
the physical clustering of its rows:

  CACHE_ROW_CHUNK  — seed ``(tp, hk, c)``: position-outer.  The decode
                     INSERT writes one contiguous row block; the attention
                     join's per-head scan is strided by position.
  CACHE_HEAD_MAJOR — ``(hk, tp, c)``: head-outer.  The decode attention
                     join scans each KV head's history as one contiguous
                     run; the INSERT scatters one slot per head.
  CACHE_POS_MAJOR  — ``(tp, c, hk)``: position/chunk-outer, head-inner.
                     The GQA head-group gather is contiguous per (position,
                     chunk); reads for a single head are fully strided.

The executor's joins are key-*name* based, so any permutation is
semantically transparent — the choice only moves bytes (§4's layout
co-design lever for the decode-dominant attention joins).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core import relational as ra
from repro_torch.core.opmap import CACHE_KEY_ORDERS
from repro_torch.core.relational import (
    BinOp, Call, Col, Collect, Const, GroupAgg, Join, Key, Project, RelNode,
    RelSchema, Scan, resolve, VEC,
)

ROW_CHUNK = "row_chunk"
COL_CHUNK = "col_chunk"
COL_CHUNK_HEADS = "col_chunk_heads"

COL_SUFFIX = "__col"
COLH_SUFFIX = "__colh"

# -- cache layouts ----------------------------------------------------------
# The layout-name -> key-order table (CACHE_KEY_ORDERS) lives in core — the
# compiler owns the cache-table convention; the planner picks among its
# entries.

CACHE_ROW_CHUNK = "row_chunk"
CACHE_HEAD_MAJOR = "head_major"
CACHE_POS_MAJOR = "pos_major"

CACHE_LAYOUTS = tuple(CACHE_KEY_ORDERS)


def divisor_candidates(width: int, candidates, always=()) -> Tuple[int, ...]:
    """Chunk sizes from ``candidates`` that divide ``width`` (pad-free
    physical tables — a column copy's residency bytes equal the logical
    weight bytes), plus any ``always`` entries (the seed size stays
    admissible)."""
    out = {c for c in candidates if 0 < c <= width and width % c == 0}
    out.update(c for c in always if c)
    return tuple(sorted(out))


def col_table_name(row_table: str) -> str:
    return row_table + COL_SUFFIX


def colh_table_name(row_table: str) -> str:
    return row_table + COLH_SUFFIX


def col_schema(in_features: int, out_features: int, col_chunk: int,
               d_key: str = "d", chunk_key: str = "c",
               vec_col: str = "chunk") -> RelSchema:
    """Schema of the COL_CHUNK table: (d, c, chunk FLOAT[col_chunk])."""
    assert out_features % col_chunk == 0, (out_features, col_chunk)
    return RelSchema(
        keys=((d_key, in_features), (chunk_key, out_features // col_chunk)),
        cols=((vec_col, VEC(col_chunk)),),
    )


def colh_schema(n_heads: int, in_features: int, head_dim: int,
                col_chunk: int, head_key: str = "h", d_key: str = "d",
                chunk_key: str = "c", vec_col: str = "chunk") -> RelSchema:
    """Schema of the COL_CHUNK_HEADS table: (h, d, c, chunk FLOAT[cs']).

    The head key stays a block key outside the transposed (d, c) pair, so
    the per-head output chunking never folds it.
    """
    assert head_dim % col_chunk == 0, (head_dim, col_chunk)
    return RelSchema(
        keys=((head_key, n_heads), (d_key, in_features),
              (chunk_key, head_dim // col_chunk)),
        cols=((vec_col, VEC(col_chunk)),),
    )


def cache_schema(seed_schema: RelSchema, layout: str) -> RelSchema:
    """Permute a seed ``(tp, hk, c)`` cache schema into ``layout``'s order.

    Batched (4-key) cache schemas keep their leading ``seq`` key in place —
    the layout permutes the physical clustering *within* one sequence's
    rows; sequences stay the outermost blocks.
    """
    perm = CACHE_KEY_ORDERS[layout]
    lead = seed_schema.keys[:-3]          # () or ((seq, B),)
    tail = seed_schema.keys[-3:]
    return RelSchema(keys=lead + tuple(tail[i] for i in perm),
                     cols=seed_schema.cols)


@dataclasses.dataclass(frozen=True)
class MatmulSite:
    """A matched matmul site (``map_linear`` or ``map_linear_heads`` shape).

    ``root`` is the bind-step plan root (the ROW_CHUNK plan's trailing
    ``Collect``); the remaining fields are everything the rewrite and the
    cost model need.  ``head_key`` is None for the two-key ``map_linear``
    shape; for the per-head shape it names the head block key and
    ``n_heads``/``out_features`` describe one head block (out_features =
    head_dim).
    """

    step_name: str          # bind step producing this matmul
    root: RelNode           # Collect node: plan root of the bind
    rechunk_proj: Project   # π splitting j -> (c, e)
    agg: GroupAgg           # γ_{(..., j), SUM(dot)}
    join: Join              # x ⋈ W ON c
    weight_scan: Scan       # Scan(W) — ROW_CHUNK
    x_plan: RelNode         # left (activation) input, chunked (..., c)
    x_col: str              # activation vector column name
    base_keys: Tuple[Tuple[str, int], ...]  # x keys excluding the chunk key
    in_features: int
    out_features: int       # per head block when head_key is not None
    row_chunk: int          # cs of the input-dim chunking (ROW_CHUNK vec)
    col_chunk: int          # cs of the output-dim chunking (COL_CHUNK vec)
    out_col: str            # output vector column name (Collect.vec_col)
    head_key: Optional[str] = None  # per-head block key (map_linear_heads)
    n_heads: int = 1

    @property
    def table(self) -> str:
        return self.weight_scan.table

    @property
    def is_head_site(self) -> bool:
        return self.head_key is not None

    @property
    def n_in_chunks(self) -> int:
        return self.in_features // self.row_chunk

    @property
    def n_out_chunks(self) -> int:
        return self.out_features // self.col_chunk

    @property
    def col_layout(self) -> str:
        """The column layout this site admits."""
        return COL_CHUNK_HEADS if self.is_head_site else COL_CHUNK

    @property
    def col_table(self) -> str:
        return (colh_table_name(self.table) if self.is_head_site
                else col_table_name(self.table))

    @property
    def weight_bytes(self) -> int:
        """f32 bytes of one physical copy of this weight (either layout)."""
        return 4 * self.n_heads * self.out_features * self.in_features

    @property
    def seq_len(self) -> int:
        """Tokens per invocation at this site: the product of the
        activation's base keys excluding the head block key."""
        t = 1
        for k, s in self.base_keys:
            if k != self.head_key:
                t *= s
        return t

    def row_chunk_candidates(self, candidates=()) -> Tuple[int, ...]:
        """Physical chunk sizes admissible for the ROW_CHUNK table: sizes
        dividing the *input* dimension (pad-free), plus the seed size."""
        return divisor_candidates(self.in_features, candidates,
                                   always=(self.row_chunk,))

    def col_chunk_candidates(self, candidates=()) -> Tuple[int, ...]:
        """Physical chunk sizes admissible for the column table: sizes
        dividing the *output* dimension (head_dim for head sites — the
        head key is a block key, so chunking never crosses it), plus the
        seed size."""
        return divisor_candidates(self.out_features, candidates,
                                   always=(self.col_chunk,))


def _dot_cols(expr) -> Optional[Tuple[str, str]]:
    if isinstance(expr, Call) and expr.fn == "dot" and all(
            isinstance(a, Col) for a in expr.args):
        return expr.args[0].name, expr.args[1].name
    return None


def _split_source(proj_keys) -> Optional[str]:
    """Name of the key split into (chunk, elem) by the re-chunk projection:
    the trailing two key defs must be ``Key(r) // cs`` and ``Key(r) % cs``
    over the same source key."""
    (_, _, e_hi), (_, _, e_lo) = proj_keys[-2:]
    if (isinstance(e_hi, BinOp) and e_hi.op == "//"
            and isinstance(e_hi.lhs, Key) and isinstance(e_hi.rhs, Const)
            and isinstance(e_lo, BinOp) and e_lo.op == "%"
            and isinstance(e_lo.lhs, Key) and e_lo.lhs.name == e_hi.lhs.name):
        return e_hi.lhs.name
    return None


def match_matmul_site(step_name: str, root: RelNode) -> Optional[MatmulSite]:
    """Match a matmul plan shape rooted at a bind step:

        Collect(Project(GroupAgg(Join(x, Scan(W)))))

    with the GroupAgg a single ``SUM(dot(x_col, chunk_col))`` grouped by the
    weight's row key(s), the Join an equi-join on the shared chunk key, and
    the Project the re-chunk split ``j -> (c, e)``.  Matches both the
    two-key ``map_linear`` weights ``W(j, c, chunk)`` and the three-key
    per-head ``map_linear_heads`` weights ``W(h, r, c, chunk)`` (the head
    key is carried through as a block key).  Returns None for any other
    shape (attention, embeddings, norms, …).
    """
    if not isinstance(root, Collect):
        return None
    proj = root.input
    if not isinstance(proj, Project) or proj.keys is None:
        return None
    agg = proj.input
    if not isinstance(agg, GroupAgg) or len(agg.aggs) != 1:
        return None
    out, fn, expr = agg.aggs[0]
    if fn != "SUM":
        return None
    dot = _dot_cols(expr)
    if dot is None:
        return None
    join = agg.input
    if not isinstance(join, Join) or not isinstance(join.right, Scan):
        return None
    scan = join.right
    ws = scan.table_schema
    # two-key (j, c) or three-key (h, r, c) row-chunked weight + one vec col
    if len(ws.keys) not in (2, 3) or len(ws.cols) != 1:
        return None
    wcol, wtype = ws.cols[0]
    if not ra.is_vec(wtype):
        return None
    cname, _ = ws.keys[-1]
    # join must bind the weight's chunk key to the activation's chunk key
    if len(join.on) != 1:
        return None
    on_key, on_expr = join.on[0]
    if on_key != cname or not isinstance(on_expr, Key):
        return None
    # the dot must pair the activation column with the weight column
    a, b = dot
    if b == wcol:
        x_col = a
    elif a == wcol:
        x_col = b
    else:
        return None
    xs = resolve(join.left)
    if x_col not in xs.col_names or on_expr.name not in xs.key_names:
        return None
    base_keys = tuple((k, s) for k, s in xs.keys if k != on_expr.name)
    # the re-chunk projection splits the weight's row key into (chunk, elem)
    if len(proj.keys) < 2:
        return None
    fold = _split_source(proj.keys)
    if fold is None:
        return None
    head_key: Optional[str] = None
    n_heads = 1
    if len(ws.keys) == 2:
        (jname, out_f), _ = ws.keys
        if jname != fold:
            return None
        if len(proj.keys) != len(base_keys) + 2:
            return None
    else:
        (hname, n_heads), (rname, out_f), _ = ws.keys
        if rname != fold:
            return None
        if hname not in agg.group_keys:
            return None
        if len(proj.keys) != len(base_keys) + 3:
            return None
        head_key = hname
    # group keys: all activation keys except the chunk key, plus the
    # weight's row key(s)
    row_keys = {fold} | ({head_key} if head_key else set())
    if fold not in agg.group_keys:
        return None
    if set(agg.group_keys) != {k for k, _ in base_keys} | row_keys:
        return None
    (ck, n_out_chunks, _), (ek, cs_out, _) = proj.keys[-2:]
    if root.fold_key != ek or cs_out * n_out_chunks != out_f:
        return None
    return MatmulSite(
        step_name=step_name,
        root=root,
        rechunk_proj=proj,
        agg=agg,
        join=join,
        weight_scan=scan,
        x_plan=join.left,
        x_col=x_col,
        base_keys=base_keys,
        in_features=xs.key_size(on_expr.name) * ra.vec_width(
            xs.col_type(x_col)),
        out_features=out_f,
        row_chunk=ra.vec_width(wtype),
        col_chunk=cs_out,
        out_col=root.vec_col,
        head_key=head_key,
        n_heads=n_heads,
    )


def admissible_layouts(site: Optional[MatmulSite]) -> Tuple[str, ...]:
    """Physical layouts legal for a (candidate) weight scan."""
    if site is None:
        return (ROW_CHUNK,)
    if site.is_head_site:
        return (ROW_CHUNK, COL_CHUNK_HEADS)
    return (ROW_CHUNK, COL_CHUNK)


# ---------------------------------------------------------------------------
# Cache sites
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CacheSite:
    """A planner-managed KV-cache table: its append step + every Scan of it.

    ``scans`` share one mutable ``RelSchema`` by reference through the
    pipeline DAG, so re-laying the table out rewrites every consumer at
    once.  ``pos_key``/``head_key``/``chunk_key`` name the seed key roles;
    ``n_pos``/``n_heads``/``n_chunks``/``chunk`` size the cost model.
    """

    table: str
    scans: Tuple[Scan, ...]
    pos_key: str
    head_key: str
    chunk_key: str
    n_pos: int
    n_heads: int
    n_chunks: int
    chunk: int
    # batched pipelines: the cache's leading sequence key and its size (the
    # per-tick batch B) — pricing multiplies the per-sequence locality terms
    # by the batch, and the layout permutation leaves the seq key leading
    seq_key: Optional[str] = None
    batch: int = 1

    @property
    def seed_schema(self) -> RelSchema:
        """The seed (tp, hk, c) schema — with any leading seq key kept in
        front — regardless of current key order."""
        s = self.scans[0].table_schema
        order = {self.pos_key: 1, self.head_key: 2, self.chunk_key: 3}
        if self.seq_key is not None:
            order[self.seq_key] = 0
        keys = tuple(sorted(s.keys, key=lambda k: order[k[0]]))
        return RelSchema(keys=keys, cols=s.cols)

    @property
    def head_dim(self) -> int:
        """Width of the cached per-head vectors (n_chunks · chunk)."""
        return self.n_chunks * self.chunk

    def chunk_candidates(self, candidates=()) -> Tuple[int, ...]:
        """Chunk sizes admissible for this cache table: divisors of the
        head dim, plus the current size.  The cache chunking is tied to
        the pipeline chunking (appends and both attention joins share it
        with Q/K/V), so these inform the *global* chunk-size choice
        rather than a per-table rewrite."""
        return divisor_candidates(self.head_dim, candidates,
                                  always=(self.chunk,))


def pipeline_nodes(pipeline):
    """Every distinct relational node of a pipeline's step plans, in the
    order per-step ``walk``s first meet them.  One post-order walk keeps
    its visited set across the steps: each step's plan embeds every
    earlier step's, so a fresh walk per step (the reference's) is
    quadratic in depth — most of a 32-layer plan's compile time.  A node
    first met in an earlier step has its whole subtree met there too, so
    skipping it changes no first-meeting order."""
    seen: set = set()

    def rec(n):
        if id(n) in seen:
            return
        seen.add(id(n))
        if not isinstance(n, Scan):
            for f in dataclasses.fields(n):
                v = getattr(n, f.name)
                if isinstance(v, RelNode):
                    yield from rec(v)
        yield n

    for step in pipeline.steps:
        yield from rec(step.rel.plan)


def match_value_join_tables(pipeline) -> Dict[str, RelSchema]:
    """Weight tables consumed through a *value* join (an embedding-style
    lookup: the join binds a key of the table to a data column, e.g.
    ``vocabulary.tok = ids.s``).

    These are not matmul sites — no layout rewrite applies — but their
    payloads are chunk vectors like any weight table, so they are legal
    *precision* candidates (the vocabulary table is typically among the
    largest tables in the model).  Norm vectors joined on shared keys
    (``Key`` expressions) are deliberately excluded: their byte footprint
    is negligible and quantising them buys nothing.
    """
    from repro_torch.core.relational import Col, Join
    out: Dict[str, RelSchema] = {}
    for node in pipeline_nodes(pipeline):
        if not isinstance(node, Join) or not isinstance(node.right, Scan):
            continue
        scan = node.right
        if scan.table not in pipeline.weight_schemas:
            continue
        if not any(isinstance(e, Col) for _, e in node.on):
            continue
        s = scan.table_schema
        if len(s.cols) == 1 and ra.is_vec(s.cols[0][1]):
            out[scan.table] = s
    return out


def match_cache_sites(pipeline) -> Tuple[CacheSite, ...]:
    """Find every append-target cache table and all Scans referencing it.

    Cache tables are the targets of ``append`` steps; their seed schema is
    ``(pos, head, chunk) + one vec column`` (``opmap.map_concat_rows``), or
    ``(seq, pos, head, chunk)`` for batched pipelines (the pipeline's
    ``seq_key`` names the leading batch key).
    """
    append_keys = dict(getattr(pipeline, "cache_tables", {}) or {})
    if not append_keys:  # pipelines from older compilers: derive from steps
        append_keys = {s.name: s.append_key for s in pipeline.steps
                       if s.kind == "append"}
    seq_key = getattr(pipeline, "seq_key", None)
    scans: Dict[str, list] = {}
    for node in pipeline_nodes(pipeline):
        if isinstance(node, Scan) and node.table in append_keys:
            scans.setdefault(node.table, []).append(node)
    sites = []
    for table, table_scans in scans.items():
        schema = table_scans[0].table_schema
        if len(schema.cols) != 1:
            continue
        names = dict(schema.keys)
        batched = (seq_key is not None and len(schema.keys) == 4
                   and seq_key in names)
        if not batched and len(schema.keys) != 3:
            continue
        pos_key = append_keys[table]
        if pos_key not in names:
            continue
        # the chunk key is "c" by construction; the head key is the third
        skip = (pos_key, "c") + ((seq_key,) if batched else ())
        others = [k for k in schema.key_names if k not in skip]
        if "c" not in names or len(others) != 1:
            continue
        head_key = others[0]
        sites.append(CacheSite(
            table=table,
            scans=tuple(table_scans),
            pos_key=pos_key,
            head_key=head_key,
            chunk_key="c",
            n_pos=names[pos_key],
            n_heads=names[head_key],
            n_chunks=names["c"],
            chunk=ra.vec_width(schema.cols[0][1]),
            seq_key=seq_key if batched else None,
            batch=names[seq_key] if batched else 1,
        ))
    return tuple(sites)
