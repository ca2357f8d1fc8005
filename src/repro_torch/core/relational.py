"""Relational-algebra IR — the compiler's intermediate abstraction (Def 2.2).

Stage 1 (``opmap``) rewrites each neural operator into a tree of these
relational nodes; stage 2 (``sqlgen``) prints the tree as SQL, and
``executor`` runs it directly on PyTorch tensors.

Execution model
---------------
All tables in the pipeline live over *dense* integer key domains (token
index, head index, chunk index, …).  A table is therefore

    RelSchema(keys=((name, size), ...), cols={col: VEC(chunk) | SCALAR})

and its relational rows are the full cross product of the key domains.  This
is exactly the paper's chunked layout (§2.1): the key tuple is the row
address.  Filters (e.g. the causal mask) are represented as *annotated*
filters that the executor realises as masks and the SQL generator as WHERE
clauses — they are the only source of non-dense relations and are always
consumed by a downstream aggregate that defines the masked identity element.

Node vocabulary
---------------
  Scan(table)                          — base table (weights, activations, caches)
  Project(input, keys, exprs)          — π: key remapping + per-row expressions
  Join(input_l, input_r, on)           — ⋈: equi-join; the right key may be an
                                          integer expression of left keys
                                          (e.g. Q.head // g = K.head, paper Tab. 2)
  GroupAgg(input, keys, aggs)          — γ: group-by surviving keys, aggregate
                                          the consumed keys (SUM / MAX / AVG;
                                          vector SUM == the paper's sumForEach)
  Filter(input, predicate)             — σ: key-predicate filter (causal mask)
  Unnest(input, vec_col)               — explode FLOAT[chunk] into scalar rows
                                          with a new position key (DuckDB UNNEST)
  Collect(input, key, vec_col)         — inverse: fold a dense key into a vector
                                          (collect_as_array in Appendix B)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

# ---------------------------------------------------------------------------
# Scalar / vector expression language (projection bodies, predicates)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Expr:
    """Base class; use the helper constructors below."""


@dataclasses.dataclass(frozen=True)
class Col(Expr):
    name: str


@dataclasses.dataclass(frozen=True)
class Key(Expr):
    """Reference to a key column (integer)."""

    name: str


@dataclasses.dataclass(frozen=True)
class Const(Expr):
    value: float


@dataclasses.dataclass(frozen=True)
class Param(Expr):
    """Runtime scalar parameter (SQL ``:name`` placeholder) — used for the
    dynamic decode position in KV-cache queries (§3.4)."""

    name: str


@dataclasses.dataclass(frozen=True)
class KeyParam(Expr):
    """Runtime *per-key* scalar parameter: the bound value is a vector
    indexed by the named key, so one plan serves every row of the key
    domain with its own scalar.  Used by the batched decode pipeline for
    the per-sequence cache position (``seq_positions[seq]``): the causal
    mask of sequence ``s`` compares against *its* position, not a global
    one.  SQL renders it as a 1-indexed list-parameter lookup
    (``list_extract(:name, key + 1)``)."""

    name: str
    key: str


@dataclasses.dataclass(frozen=True)
class BinOp(Expr):
    """Elementwise arithmetic.  On vector columns this is the paper's
    hadamard_prod / element_sum / element_neg_sum UDF family."""

    op: str  # + - * / // % min max
    lhs: Expr
    rhs: Expr


@dataclasses.dataclass(frozen=True)
class Call(Expr):
    """Intrinsic or vector-UDF call.

    fn ∈ { exp, silu, gelu, sigmoid, sqrt, rsqrt, neg, square, dot,
           scale, concat, first_half, second_half, where_leq }
    ``dot(a, b)`` : FLOAT[c] × FLOAT[c] → scalar   (list_dot / inner product)
    ``concat``    : view_as_real in Appendix B
    ``first_half/second_half`` : RoPE complex split
    """

    fn: str
    args: Tuple[Expr, ...]


def col(name: str) -> Col:
    return Col(name)


def key(name: str) -> Key:
    return Key(name)


def const(v: float) -> Const:
    return Const(float(v))


def call(fn: str, *args: Expr) -> Call:
    return Call(fn, tuple(args))


def add(a: Expr, b: Expr) -> BinOp:
    return BinOp("+", a, b)


def sub(a: Expr, b: Expr) -> BinOp:
    return BinOp("-", a, b)


def mul(a: Expr, b: Expr) -> BinOp:
    return BinOp("*", a, b)


def div(a: Expr, b: Expr) -> BinOp:
    return BinOp("/", a, b)


def floordiv(a: Expr, b: Expr) -> BinOp:
    return BinOp("//", a, b)


def mod(a: Expr, b: Expr) -> BinOp:
    return BinOp("%", a, b)


# ---------------------------------------------------------------------------
# Schemas
# ---------------------------------------------------------------------------

SCALAR = "scalar"


def VEC(n: int) -> str:
    return f"vec[{n}]"


def is_vec(coltype: str) -> bool:
    return coltype.startswith("vec[")


def vec_width(coltype: str) -> int:
    return int(coltype[4:-1])


@dataclasses.dataclass(frozen=True)
class RelSchema:
    keys: Tuple[Tuple[str, int], ...]
    cols: Tuple[Tuple[str, str], ...]  # (col_name, SCALAR | vec[n])

    @property
    def key_names(self) -> Tuple[str, ...]:
        return tuple(k for k, _ in self.keys)

    @property
    def col_names(self) -> Tuple[str, ...]:
        return tuple(c for c, _ in self.cols)

    def key_size(self, name: str) -> int:
        for k, s in self.keys:
            if k == name:
                return s
        raise KeyError(name)

    def col_type(self, name: str) -> str:
        for c, t in self.cols:
            if c == name:
                return t
        raise KeyError(name)


# ---------------------------------------------------------------------------
# Relational nodes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RelNode:
    schema: Optional[RelSchema] = dataclasses.field(default=None, init=False)
    name: str = dataclasses.field(default="", init=False)


@dataclasses.dataclass
class Scan(RelNode):
    table: str
    table_schema: RelSchema

    def __post_init__(self):
        self.schema = self.table_schema
        self.name = self.table


@dataclasses.dataclass
class Project(RelNode):
    input: RelNode
    # output key definitions: (key_name, size, integer Expr over input keys);
    # None keeps the input keys unchanged (pure column projection)
    keys: Optional[List[Tuple[str, int, Expr]]]
    # output column definitions: (col_name, coltype-or-None, Expr)
    exprs: List[Tuple[str, Optional[str], Expr]]


@dataclasses.dataclass
class Join(RelNode):
    left: RelNode
    right: RelNode
    # equi-join conditions: (right_key_name, Expr over *left* keys)
    on: List[Tuple[str, Expr]]
    # columns to keep: None = all (prefixed resolution handled by planner)
    how: str = "inner"


@dataclasses.dataclass
class GroupAgg(RelNode):
    input: RelNode
    group_keys: List[str]
    # (out_col, agg_fn, input Expr); agg_fn ∈ SUM MAX AVG; vector exprs use
    # elementwise aggregation (sumForEach)
    aggs: List[Tuple[str, str, Expr]]


@dataclasses.dataclass
class Filter(RelNode):
    input: RelNode
    # predicate over keys: (op, lhs Expr, rhs Expr) with op ∈ {<=, <, ==, >=}
    predicate: Tuple[str, Expr, Expr]
    # identity element used by the consuming aggregate for masked-out rows
    masked_value: float = 0.0


@dataclasses.dataclass
class Unnest(RelNode):
    input: RelNode
    vec_col: str
    elem_key: str = "e"
    elem_col: str = "x"


@dataclasses.dataclass
class Collect(RelNode):
    input: RelNode
    fold_key: str  # innermost dense key folded into the vector
    scalar_col: str
    vec_col: str = "chunk"


REL_NODE_TYPES = (Scan, Project, Join, GroupAgg, Filter, Unnest, Collect)


def walk(node: RelNode):
    """Post-order traversal of a relational plan (DAG-deduplicated)."""
    seen: set = set()

    def _walk(n: RelNode):
        if id(n) in seen:
            return
        seen.add(id(n))
        if not isinstance(n, Scan):
            for f in dataclasses.fields(n):
                v = getattr(n, f.name)
                if isinstance(v, RelNode):
                    yield from _walk(v)
        yield n

    yield from _walk(node)


# ---------------------------------------------------------------------------
# Schema resolution
# ---------------------------------------------------------------------------


def expr_type(expr: Expr, schema: RelSchema) -> str:
    """Column type (SCALAR | vec[n]) of an expression over ``schema``."""
    if isinstance(expr, Col):
        return schema.col_type(expr.name)
    if isinstance(expr, (Key, Const, Param, KeyParam)):
        return SCALAR
    if isinstance(expr, BinOp):
        lt, rt = expr_type(expr.lhs, schema), expr_type(expr.rhs, schema)
        if is_vec(lt):
            return lt
        return rt
    if isinstance(expr, Call):
        ats = [expr_type(a, schema) for a in expr.args]
        if expr.fn in ("dot", "vsum"):
            return SCALAR
        if expr.fn == "concat":
            return VEC(sum(vec_width(t) for t in ats))
        if expr.fn in ("first_half", "second_half"):
            return VEC(vec_width(ats[0]) // 2)
        # elementwise intrinsics preserve the first argument's type
        return ats[0]
    raise TypeError(f"unknown expr {expr!r}")


def resolve(node: RelNode) -> RelSchema:
    """Infer and cache ``node.schema`` bottom-up."""
    if node.schema is not None:
        return node.schema
    if isinstance(node, Scan):
        node.schema = node.table_schema
    elif isinstance(node, Project):
        in_s = resolve(node.input)
        keys = tuple((k, s) for k, s, _ in node.keys) if node.keys is not None \
            else in_s.keys
        cols = tuple((c, t if t is not None else expr_type(e, in_s))
                     for c, t, e in node.exprs)
        node.schema = RelSchema(keys=keys, cols=cols)
    elif isinstance(node, Join):
        ls, rs = resolve(node.left), resolve(node.right)
        joined = {k for k, _ in node.on}
        keys = ls.keys + tuple((k, s) for k, s in rs.keys if k not in joined)
        lcols = dict(ls.cols)
        cols = list(ls.cols)
        for c, t in rs.cols:
            cols.append((c if c not in lcols else c + "_r", t))
        node.schema = RelSchema(keys=keys, cols=tuple(cols))
    elif isinstance(node, GroupAgg):
        in_s = resolve(node.input)
        keys = tuple((k, s) for k, s in in_s.keys if k in node.group_keys)
        cols = []
        for out, fn, e in node.aggs:
            t = expr_type(e, in_s)
            cols.append((out, t))
        node.schema = RelSchema(keys=keys, cols=tuple(cols))
    elif isinstance(node, Filter):
        node.schema = resolve(node.input)
    elif isinstance(node, Unnest):
        in_s = resolve(node.input)
        w = vec_width(in_s.col_type(node.vec_col))
        keys = in_s.keys + ((node.elem_key, w),)
        cols = tuple((c, t) for c, t in in_s.cols if c != node.vec_col) + (
            (node.elem_col, SCALAR),)
        node.schema = RelSchema(keys=keys, cols=cols)
    elif isinstance(node, Collect):
        in_s = resolve(node.input)
        w = in_s.key_size(node.fold_key)
        keys = tuple((k, s) for k, s in in_s.keys if k != node.fold_key)
        cols = tuple((c, t) for c, t in in_s.cols if c != node.scalar_col) + (
            (node.vec_col, VEC(w)),)
        node.schema = RelSchema(keys=keys, cols=cols)
    else:
        raise TypeError(node)
    return node.schema
