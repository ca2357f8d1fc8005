"""Vectorised columnar executor — runs relational plans on PyTorch tensors.

The "database engine" half of the system: a dense-key columnar engine whose
physical operators lower to tensor operations on one device:

  Scan           → tensor lookup in the environment
  Project        → elementwise ops + reshape/permute key remaps
  Join (dense)   → address arithmetic: gather along the joined key axes
  GroupAgg       → axis reduction
  Filter         → predicate mask (identity element supplied by the plan)
  Unnest/Collect → reshapes between key axes and the vector payload axis

Physical optimisation (the "query optimiser"): a ``GroupAgg(Join(L, R))``
whose aggregate is ``SUM`` of a product/dot of one column from each side is
executed as a fused contraction — the relational join never materialises,
as a vectorised DB pipelines a hash join into an aggregation.  When the
contraction is a plain 2-D GEMM (the chunk-key join of every linear layer,
Q/K/V and lm_head: ``γ_{G_L+G_R, SUM(dot)}(L ⋈_c R)``) it runs on the
hand-written ``kernels.chunked_matmul``; other fused contractions run
``torch.einsum``.

The attention subplan of every layer — the score join
``γ_SUM(scale(dot))(Q ⋈ Kcache)``, the causal-mask Filter, the softmax's
``γ_MAX → π exp → γ_SUM → π div`` and the output join
``γ_SUM(mul)(P ⋈ Vcache)`` — is recognised as one unit at its output
GroupAgg and runs on one hand-written kernel: ``kernels.paged_attention``
for a decode step (one query row per sequence, masked by that sequence's
position; single or batched) and ``kernels.flash_attention`` for a prefill
(T query rows, causal from offset 0).  Any other mask form (the suffix
prefill's runtime offset) takes the generic operators.

Index tensors are ``int64`` throughout.  Where the JAX reference clamps an
out-of-bounds gather index or drops an out-of-bounds scatter, this executor
raises ``IndexError`` on the host before anything is launched.
"""

from __future__ import annotations

import dataclasses
import math
import operator
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import relational as ra
from repro_torch.core.relational import (
    BinOp, Call, Col, Collect, Const, Expr, Filter, GroupAgg, Join, Key,
    KeyParam, Param, Project, RelNode, RelSchema, Scan, Unnest, SCALAR,
    is_vec, resolve, vec_width,
)
from repro_torch.kernels import chunked_matmul, flash_attention, paged_attention

@dataclasses.dataclass
class DenseTable:
    """A relation over dense integer key domains.

    ``cols[name]`` has shape ``[*key_sizes]`` (scalar column) or
    ``[*key_sizes, w]`` (vector column).
    """

    keys: Tuple[Tuple[str, int], ...]
    cols: Dict[str, torch.Tensor]
    col_types: Dict[str, str]

    @property
    def key_names(self):
        return tuple(k for k, _ in self.keys)

    @property
    def key_sizes(self):
        return tuple(s for _, s in self.keys)

    @property
    def device(self) -> torch.device:
        return next(iter(self.cols.values())).device

    def schema(self, name: str = "t") -> RelSchema:
        return RelSchema(keys=self.keys,
                         cols=tuple((c, self.col_types[c]) for c in self.cols))


def table_from_chunked(ct) -> DenseTable:
    """Wrap a ChunkedTensor as a DenseTable (zero-copy)."""
    return DenseTable(
        keys=ct.schema.key_cols,
        cols={ct.schema.vec_col: ct.data},
        col_types={ct.schema.vec_col: ra.VEC(ct.schema.chunk_size)},
    )


def scalar_table(name: str, key_cols, tensor, col="s") -> DenseTable:
    return DenseTable(keys=tuple(key_cols), cols={col: tensor},
                      col_types={col: SCALAR})


def permute_table_keys(table: DenseTable, key_order) -> DenseTable:
    """Re-key a DenseTable to a new physical key order (name-based axis
    permute) — the executor realisation of a cache-layout choice.  Vector
    columns keep their trailing payload axis."""
    key_order = tuple(key_order)
    if key_order == table.key_names:
        return table
    if set(key_order) != set(table.key_names):
        raise ValueError(f"key order {key_order} does not permute "
                         f"{table.key_names}")
    perm = [table.key_names.index(k) for k in key_order]
    sizes = dict(table.keys)
    cols, col_types = {}, {}
    for c, arr in table.cols.items():
        axes = perm + ([len(perm)] if is_vec(table.col_types[c]) else [])
        cols[c] = arr.permute(*axes)
        col_types[c] = table.col_types[c]
    return DenseTable(keys=tuple((k, sizes[k]) for k in key_order),
                      cols=cols, col_types=col_types)


# ---------------------------------------------------------------------------
# Key expressions
# ---------------------------------------------------------------------------

_KEY_OPS = {"+": operator.add, "-": operator.sub, "*": operator.mul,
            "//": operator.floordiv, "%": operator.mod}


def _eval_key_expr(expr: Expr, key_names, key_sizes, arange, scalars=None):
    """Evaluate an integer expression over key columns.

    Returns an array broadcastable against ``[*key_sizes]`` (aranges are
    reshaped into their key's axis position, so e.g. ``h // 4`` stays O(H)).
    ``arange(n)`` makes the key domains: numpy on the host for join
    indices (bounds-checked, then cached on the device), torch on the
    device for filter predicates that read runtime parameters.  ``//`` and
    ``%`` floor on both, as in the reference.
    """
    nk = len(key_names)
    scalars = scalars or {}

    def axis_shape(name):
        ax = key_names.index(name)
        shape = [1] * nk
        shape[ax] = key_sizes[ax]
        return shape

    def rec(e: Expr):
        if isinstance(e, Key):
            return arange(key_sizes[key_names.index(e.name)]).reshape(
                axis_shape(e.name))
        if isinstance(e, Const):
            return int(e.value)
        if isinstance(e, Param):
            return scalars[e.name]
        if isinstance(e, KeyParam):
            # per-key parameter vector: bound value has one entry per row
            # of the key domain, broadcast into that key's axis
            return scalars[e.name].reshape(axis_shape(e.key))
        if isinstance(e, BinOp):
            return _KEY_OPS[e.op](rec(e.lhs), rec(e.rhs))
        raise TypeError(f"not a key expression: {e!r}")

    return rec(expr)


def _host_arange(n: int) -> np.ndarray:
    return np.arange(n, dtype=np.int64)


_ARANGES: Dict[tuple, torch.Tensor] = {}
_INDICES: Dict[tuple, torch.Tensor] = {}


def _arange(n: int, device) -> torch.Tensor:
    """``arange(n)`` on ``device``, made once per (n, device)."""
    k = (n, str(device))
    if k not in _ARANGES:
        _ARANGES[k] = torch.arange(n, dtype=torch.int64, device=device)
    return _ARANGES[k]


def _key_index(expr: Expr, key_names, key_sizes, bound: int, device,
               flat_axis: Optional[int] = None) -> torch.Tensor:
    """A join index computed from key arithmetic alone, bounds-checked
    against the joined domain ``[0, bound)`` on the host and cached on the
    device: plans are static, so after the first call no index is rebuilt
    and no host-device copy is made.  ``flat_axis`` flattens an index that
    depends on that one key axis to 1-D."""
    k = (expr, tuple(key_names), tuple(key_sizes), bound, str(device),
         flat_axis)
    if k not in _INDICES:
        idx = np.asarray(_eval_key_expr(expr, key_names, key_sizes,
                                        _host_arange), np.int64)
        if flat_axis is not None:
            idx = np.broadcast_to(idx, tuple(
                1 if i != flat_axis else s
                for i, s in enumerate(key_sizes))).ravel()
        if idx.size and (idx.min() < 0 or idx.max() >= bound):
            raise IndexError(
                f"join index {expr!r} over keys {dict(zip(key_names, key_sizes))}"
                f" leaves [0, {bound})")
        _INDICES[k] = torch.from_numpy(np.array(idx, np.int64)).to(device)
    return _INDICES[k]


# ---------------------------------------------------------------------------
# Expression evaluation
# ---------------------------------------------------------------------------


def _maximum(a, b):
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return torch.maximum(a, b)
    return (torch.clamp(a, min=b) if isinstance(a, torch.Tensor)
            else torch.clamp(b, min=a))


def _minimum(a, b):
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return torch.minimum(a, b)
    return (torch.clamp(a, max=b) if isinstance(a, torch.Tensor)
            else torch.clamp(b, max=a))


_BINARY = {"+": operator.add, "-": operator.sub, "*": operator.mul,
           "/": operator.truediv, "//": operator.floordiv, "%": operator.mod,
           "max": _maximum, "min": _minimum}

_UNARY = {
    "exp": torch.exp,
    "neg": torch.neg,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "sigmoid": torch.sigmoid,
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "square": torch.square,
    "identity": lambda x: x,
}


def _trailing(v):
    """Give a scalar-per-row operand a payload axis to broadcast against."""
    return v.unsqueeze(-1) if isinstance(v, torch.Tensor) and v.ndim else v


def _eval_expr(expr: Expr, table: DenseTable):
    """Evaluate a projection/aggregate expression.

    Returns ``(value, is_vec)``; scalar values have shape ``[*key_sizes]``
    (broadcastable) or are Python numbers, vector values carry a trailing
    payload axis.
    """
    if isinstance(expr, Col):
        return table.cols[expr.name], is_vec(table.col_types[expr.name])
    if isinstance(expr, Key):
        dev = table.device
        return _eval_key_expr(expr, table.key_names, table.key_sizes,
                              lambda n: _arange(n, dev)).to(
                                  torch.float32), False
    if isinstance(expr, Const):
        return expr.value, False
    if isinstance(expr, BinOp):
        (lv, lvec), (rv, rvec) = _eval_expr(expr.lhs, table), _eval_expr(
            expr.rhs, table)
        if lvec and not rvec:
            rv = _trailing(rv)
        if rvec and not lvec:
            lv = _trailing(lv)
        return _BINARY[expr.op](lv, rv), lvec or rvec
    if isinstance(expr, Call):
        if expr.fn == "dot":
            a, _ = _eval_expr(expr.args[0], table)
            b, _ = _eval_expr(expr.args[1], table)
            return (a * b).sum(-1), False
        if expr.fn == "vsum":
            a, _ = _eval_expr(expr.args[0], table)
            return a.sum(-1), False
        if expr.fn == "scale":
            a, av = _eval_expr(expr.args[0], table)
            s, _ = _eval_expr(expr.args[1], table)
            return a * s, av
        if expr.fn == "concat":
            parts = [_eval_expr(a, table)[0] for a in expr.args]
            return torch.cat(parts, dim=-1), True
        if expr.fn == "first_half":
            a, _ = _eval_expr(expr.args[0], table)
            return a[..., : a.shape[-1] // 2], True
        if expr.fn == "second_half":
            a, _ = _eval_expr(expr.args[0], table)
            return a[..., a.shape[-1] // 2:], True
        if expr.fn == "nf4_dequant":
            raise NotImplementedError(
                "nf4_dequant needs the quantised payload codecs: see "
                "ROADMAP.md next slice N4 (codecs and pager)")
        if expr.fn in _UNARY:
            a, av = _eval_expr(expr.args[0], table)
            return _UNARY[expr.fn](a), av
        raise NotImplementedError(f"intrinsic {expr.fn}")
    raise TypeError(expr)


def _full(value, shape, device) -> torch.Tensor:
    """``value`` broadcast to ``shape`` as a tensor on ``device``."""
    if not isinstance(value, torch.Tensor):
        return torch.full(shape, value, dtype=torch.float32, device=device)
    return value if tuple(value.shape) == tuple(shape) else \
        torch.broadcast_to(value, shape)


# ---------------------------------------------------------------------------
# Key-remap (Project.keys) structural compiler: split / merge / permute
# ---------------------------------------------------------------------------


def _apply_key_remap(arr: torch.Tensor, in_keys, out_defs):
    """Realise an integer key remapping as reshape/permute.

    ``out_defs``: list of (name, size, Expr) where each Expr is one of
      Key(k)                      — rename / permute
      Key(k) // n                 — high part of a split
      Key(k) % n                  — low part of a split
      Key(a) * n + Key(b)         — merge (a outer, b inner, n = size of b)
    This is the paper's "integer-based remapping via a single projection".
    """
    in_names = [k for k, _ in in_keys]
    in_sizes = [s for _, s in in_keys]

    # --- split pass: input axes referenced via // and % get reshaped apart
    split_spec: Dict[str, Optional[int]] = {}
    for _, _, e in out_defs:
        for sub in _iter_exprs(e):
            if isinstance(sub, BinOp) and sub.op in ("//", "%") and isinstance(
                    sub.lhs, Key) and isinstance(sub.rhs, Const):
                n = int(sub.rhs.value)
                prev = split_spec.get(sub.lhs.name)
                if prev is not None and prev != n:
                    raise ValueError(
                        f"inconsistent split factors for key {sub.lhs.name}")
                split_spec[sub.lhs.name] = n

    mid_names, mid_shape = [], []
    for name, size in zip(in_names, in_sizes):
        if name in split_spec:
            n = split_spec[name]
            mid_names += [f"{name}::hi", f"{name}::lo"]
            mid_shape += [size // n, n]
        else:
            mid_names.append(name)
            mid_shape.append(size)
    arr = arr.reshape(*mid_shape, *(arr.shape[len(in_sizes):]))

    # --- map each output def to the intermediate axes it consumes
    def axes_for(e: Expr):
        if isinstance(e, Key):
            return [mid_names.index(e.name)]
        if isinstance(e, BinOp) and e.op == "//":
            return [mid_names.index(f"{e.lhs.name}::hi")]
        if isinstance(e, BinOp) and e.op == "%":
            return [mid_names.index(f"{e.lhs.name}::lo")]
        if isinstance(e, BinOp) and e.op == "+":
            # Key(a)*n + <inner>; inner may itself be a split part
            mul = e.lhs
            assert isinstance(mul, BinOp) and mul.op == "*", (
                f"unsupported merge expr {e!r}")
            return axes_for(mul.lhs) + axes_for(e.rhs)
        raise ValueError(f"unsupported key remap expr {e!r}")

    perm, out_group_sizes = [], []
    for _, size, e in out_defs:
        perm += axes_for(e)
        out_group_sizes.append(size)
    tail = list(range(len(mid_shape), arr.ndim))
    arr = arr.permute(*perm, *tail)
    return arr.reshape(*out_group_sizes, *(arr.shape[len(perm):]))


def _iter_exprs(e: Expr):
    yield e
    if isinstance(e, BinOp):
        yield from _iter_exprs(e.lhs)
        yield from _iter_exprs(e.rhs)
    elif isinstance(e, Call):
        for a in e.args:
            yield from _iter_exprs(a)


# ---------------------------------------------------------------------------
# Join: gather right-side columns along joined key axes
# ---------------------------------------------------------------------------


def _gather_right(left: DenseTable, right: DenseTable, on, rcol: str):
    """Gather a right column into the joined table's key space.

    Result axes: [*left_keys, *surviving_right_keys] (+payload).
    """
    joined = dict(on)  # right_key -> Expr over left keys / left columns
    l_sizes = left.key_sizes
    surv = [(k, s) for k, s in right.keys if k not in joined]
    out_rank = len(l_sizes) + len(surv)
    dev = right.device

    idx_arrays = []
    surv_pos = 0
    for k, s in right.keys:
        if k in joined:
            idx = _join_index(joined[k], left, s)
            idx = torch.broadcast_to(idx, l_sizes).reshape(
                l_sizes + (1,) * len(surv))
        else:
            shape = [1] * out_rank
            shape[len(l_sizes) + surv_pos] = s
            idx = _arange(s, dev).reshape(shape)
            surv_pos += 1
        idx_arrays.append(idx)

    rarr = right.cols[rcol]
    if is_vec(right.col_types[rcol]):
        return rarr[tuple(idx_arrays) + (slice(None),)]
    return rarr[tuple(idx_arrays)]


def _join_index(e: Expr, left: DenseTable, bound: int) -> torch.Tensor:
    """Index for a join condition over left keys or a left column, checked
    to lie in the joined domain ``[0, bound)``."""
    if isinstance(e, Col):  # value join, e.g. vocab.token = ids.tok
        idx = left.cols[e.name].to(torch.int64)
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= bound):
            raise IndexError(
                f"value join on column {e.name!r}: values "
                f"[{int(idx.min())}, {int(idx.max())}] leave [0, {bound}) "
                f"(e.g. a token id >= vocab)")
        return idx
    return _key_index(e, left.key_names, left.key_sizes, bound, left.device)


# ---------------------------------------------------------------------------
# Fused GroupAgg(Join) → contraction
# ---------------------------------------------------------------------------


def _is_gemm_site(node: GroupAgg, join: Join, left: DenseTable,
                  right: DenseTable, lcol: str, rcol: str) -> bool:
    """γ_{G_L+G_R, SUM(dot(l, r))}(L(G_L, c) ⋈_c R(G_R, c)) with vector
    payloads: a plain 2-D GEMM ``C = X·Wᵀ`` over the chunk key."""
    if len(join.on) != 1 or not left.keys or not right.keys:
        return False
    rkey, e = join.on[0]
    (lc, lsize), (rc, rsize) = left.keys[-1], right.keys[-1]
    return (isinstance(e, Key) and e.name == lc and rkey == rc
            and lsize == rsize
            and is_vec(left.col_types[lcol])
            and is_vec(right.col_types[rcol])
            and left.cols[lcol].shape[-1] == right.cols[rcol].shape[-1]
            and tuple(node.group_keys)
            == left.key_names[:-1] + right.key_names[:-1])


def _unit_inner(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if its inner stride is 1 (as the kernels need), else a
    contiguous copy."""
    return t if t.stride(-1) == 1 or t.shape[-1] == 1 else t.contiguous()


def _rows(t: torch.Tensor, m: int, k: int) -> torch.Tensor:
    """``t`` as an ``[m, k]`` matrix with unit inner stride (a view where
    the layout allows one)."""
    return _unit_inner(t.reshape(m, k))


def _try_fused_join_agg(node: GroupAgg, env, memo, scalars=None):
    """Recognise γ_{G, SUM(f(l_col, r_col))}(L ⋈ R) and run it fused.

    Conditions: single SUM aggregate whose expression is ``dot(a, b)``,
    ``mul(a, b)`` or ``scale(dot(a, b), c)`` with ``a`` from the left input
    and ``b`` from the right; every join condition references at most one
    left key.  GEMM-shaped sites go to the ``chunked_matmul`` kernel, the
    rest to ``torch.einsum``.  Returns None when the pattern does not apply.
    """
    if not isinstance(node.input, Join) or len(node.aggs) != 1:
        return None
    out_col, fn, expr = node.aggs[0]
    if fn != "SUM":
        return None
    scale_const = None
    if isinstance(expr, Call) and expr.fn == "scale" and isinstance(
            expr.args[1], Const):
        scale_const = expr.args[1].value
        expr = expr.args[0]
    if isinstance(expr, Call) and expr.fn == "dot":
        contract_payload = True
        a, b = expr.args
    elif isinstance(expr, BinOp) and expr.op == "*":
        contract_payload = False
        a, b = expr.lhs, expr.rhs
    else:
        return None
    if not (isinstance(a, Col) and isinstance(b, Col)):
        return None

    join = node.input
    left = execute(join.left, env, memo, scalars)
    right = execute(join.right, env, memo, scalars)
    if a.name in left.cols and b.name in right.cols:
        lcol, rcol = a.name, b.name
    elif b.name in left.cols and a.name in right.cols:
        lcol, rcol = b.name, a.name
    else:
        return None

    # join conditions must bind each right key to exactly one left key (or be
    # a value join, which the fused path does not handle)
    joined: Dict[str, str] = {}
    for rkey, e in join.on:
        keys_in = [s for s in _iter_exprs(e) if isinstance(s, Key)]
        if isinstance(e, Col) or len(keys_in) != 1:
            return None
        joined[rkey] = keys_in[0].name

    out_schema = resolve(node)
    larr, rarr = left.cols[lcol], right.cols[rcol]

    if (contract_payload and scale_const is None
            and _is_gemm_site(node, join, left, right, lcol, rcol)):
        m = math.prod(left.key_sizes[:-1])
        n = math.prod(right.key_sizes[:-1])
        k = left.key_sizes[-1] * larr.shape[-1]
        res = chunked_matmul(_rows(larr, m, k), _rows(rarr, n, k)).reshape(
            left.key_sizes[:-1] + right.key_sizes[:-1])
        return DenseTable(keys=out_schema.keys, cols={out_col: res},
                          col_types={out_col: out_schema.col_type(out_col)})

    # gather right along joined axes so its axes are named by left keys
    raxes = []
    for ax, (rkey, size) in enumerate(right.keys):
        if rkey in joined:
            e = dict(join.on)[rkey]
            if not isinstance(e, Key):  # non-trivial map, e.g. h // g
                # the expression depends on exactly one left key; flatten it
                lax = left.key_names.index(joined[rkey])
                idx1d = _key_index(e, left.key_names, left.key_sizes, size,
                                   rarr.device, flat_axis=lax)
                rarr = rarr.index_select(ax, idx1d)
            raxes.append(joined[rkey])
        else:
            raxes.append(rkey)

    lvec = is_vec(left.col_types[lcol])
    rvec = is_vec(right.col_types[rcol])

    # assign einsum letters
    letters = {}

    def letter(name):
        if name not in letters:
            letters[name] = chr(ord("a") + len(letters))
        return letters[name]

    l_sub = "".join(letter(k) for k in left.key_names) + (
        letter("__w") if lvec else "")
    r_sub = "".join(letter(k) for k in raxes) + (letter("__w") if rvec else "")
    out_vec = (lvec or rvec) and not contract_payload
    o_sub = "".join(letter(k) for k in node.group_keys) + (
        letter("__w") if out_vec else "")
    res = torch.einsum(f"{l_sub},{r_sub}->{o_sub}", larr, rarr)
    if scale_const is not None:
        res = res * scale_const

    return DenseTable(
        keys=out_schema.keys,
        cols={out_col: res},
        col_types={out_col: out_schema.col_type(out_col)},
    )


# ---------------------------------------------------------------------------
# Fused attention subplan → paged_attention (decode) / flash_attention
# (prefill)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _AttentionSite:
    """The static facts of one matched attention subplan."""

    kind: str                 # "batched" | "decode" | "prefill"
    q: RelNode                # query table (t | seq, h, c)
    k: Scan                   # K cache ((seq,) tp, hk, c)
    v: Scan                   # V cache, same keys
    q_col: str
    k_col: str
    v_col: str
    out_col: str
    head_dim: int
    offset: Optional[str]     # decode: Param name; batched: KeyParam name


# id(node) → (weak reference to the node, its site or None).  Plans are
# static per pipeline, so each attention-output node is matched once; the
# weak reference's callback drops the entry when the plan is freed.
_ATTENTION_SITES: Dict[int, tuple] = {}
_PAGE_TABLES: Dict[tuple, torch.Tensor] = {}


def _single_vec_col(scan: Scan) -> Optional[str]:
    cols = scan.table_schema.cols
    return cols[0][0] if len(cols) == 1 and is_vec(cols[0][1]) else None


def _other(expr: Expr, op_or_fn: str, known: str) -> Optional[str]:
    """For ``a <op> b`` (or ``fn(a, b)``) over two columns, one of them
    ``known``: the other column's name."""
    if isinstance(expr, BinOp) and expr.op == op_or_fn:
        args = (expr.lhs, expr.rhs)
    elif isinstance(expr, Call) and expr.fn == op_or_fn and len(expr.args) == 2:
        args = expr.args
    else:
        return None
    if not all(isinstance(a, Col) for a in args):
        return None
    names = [a.name for a in args]
    if names.count(known) != 1:
        return None
    return names[1 - names.index(known)]


def _match_attention(node: GroupAgg) -> Optional[_AttentionSite]:
    """Recognise the attention output ``γ_{t,h,c} SUM(p·v)(P ⋈ Vcache)``
    whose P is the subplan ``map_attn_scores``/``map_causal_mask``/
    ``map_softmax`` emit (``core/opmap.py``) over caches in the unplanned
    key order ``(seq,) tp, hk, c``, with scale 1/√head_dim and no chunk
    padding.  Returns None for anything else."""
    if len(node.aggs) != 1 or len(node.group_keys) != 3 \
            or not isinstance(node.input, Join) \
            or not isinstance(node.input.right, Scan):
        return None
    out_col, fn, pv_expr = node.aggs[0]
    t, h, c = node.group_keys
    pv, v_scan = node.input, node.input.right
    v_col = _single_vec_col(v_scan)
    if fn != "SUM" or (h, c) != ("h", "c") or v_col is None:
        return None
    p_col = _other(pv_expr, "*", v_col)
    p_node = pv.left
    if p_col is None or not isinstance(p_node, Project) \
            or p_node.keys is not None or len(p_node.exprs) != 1:
        return None
    # π p = ex / z over (E ⋈ Z)
    name, _, e = p_node.exprs[0]
    j2 = p_node.input
    if name != p_col or not isinstance(e, BinOp) or e.op != "/" \
            or not isinstance(j2, Join):
        return None
    identity = [(t, Key(t)), ("h", Key("h"))]
    e_node, z_node = j2.left, j2.right
    if j2.on != identity or not isinstance(e_node, Project) \
            or e_node.keys is not None or len(e_node.exprs) != 1 \
            or not isinstance(z_node, GroupAgg) or z_node.input is not e_node:
        return None
    ex_col, _, ex_expr = e_node.exprs[0]
    if e != BinOp("/", Col(ex_col), Col(z_node.aggs[0][0])) \
            or z_node.group_keys != [t, "h"] \
            or z_node.aggs != [(z_node.aggs[0][0], "SUM", Col(ex_col))]:
        return None
    # π ex = exp(s - m) over (F ⋈ M)
    j1 = e_node.input
    if not isinstance(j1, Join) or j1.on != identity \
            or not isinstance(j1.left, Filter) \
            or not isinstance(j1.right, GroupAgg):
        return None
    f_node, m_node = j1.left, j1.right
    if m_node.input is not f_node or m_node.group_keys != [t, "h"] \
            or len(m_node.aggs) != 1 or m_node.aggs[0][1] != "MAX":
        return None
    s_node = f_node.input
    if not isinstance(s_node, GroupAgg) or len(s_node.aggs) != 1:
        return None
    s_col = s_node.aggs[0][0]
    if m_node.aggs[0][2] != Col(s_col) or ex_expr != Call(
            "exp", (BinOp("-", Col(s_col), Col(m_node.aggs[0][0])),)):
        return None
    # σ tp <= bound, masked with the softmax's -inf stand-in
    op, lhs, rhs = f_node.predicate
    if op != "<=" or lhs != Key("tp") or f_node.masked_value > -1e30:
        return None
    # γ_{t,h,tp} SUM(scale(dot(q, k), 1/√d)) (Q ⋈ Kcache)
    s_expr, j0 = s_node.aggs[0][2], s_node.input
    if s_node.aggs[0][1] != "SUM" or s_node.group_keys != [t, "h", "tp"] \
            or not isinstance(j0, Join) or not isinstance(j0.right, Scan) \
            or not isinstance(s_expr, Call) or s_expr.fn != "scale" \
            or not isinstance(s_expr.args[1], Const):
        return None
    k_scan = j0.right
    k_col = _single_vec_col(k_scan)
    q_col = None if k_col is None else _other(s_expr.args[0], "dot", k_col)
    if q_col is None:
        return None
    batched = t == "seq"
    cache_keys = (("seq",) if batched else ()) + ("tp", "hk", "c")
    if k_scan.table_schema.key_names != cache_keys \
            or v_scan.table_schema.keys != k_scan.table_schema.keys \
            or v_scan.table_schema.cols[0][1] != k_scan.table_schema.cols[0][1]:
        return None
    sizes = dict(k_scan.table_schema.keys)
    n_c = sizes["c"]
    cs = vec_width(k_scan.table_schema.cols[0][1])
    head_dim = n_c * cs
    out = resolve(node)
    n_heads = out.key_size("h")
    if n_heads % sizes["hk"] or not math.isclose(
            s_expr.args[1].value, 1.0 / math.sqrt(head_dim), rel_tol=1e-6):
        return None
    group = BinOp("//", Key("h"), Const(float(n_heads // sizes["hk"])))
    seq_on = [("seq", Key("seq"))] if batched else []
    if j0.on != seq_on + [("hk", group), ("c", Key("c"))] \
            or pv.on != seq_on + [("tp", Key("tp")), ("hk", group)] \
            or out.key_size("c") != n_c:
        return None
    # the mask decides the kernel
    if batched and isinstance(rhs, KeyParam) and rhs.key == "seq":
        kind, offset = "batched", rhs.name
    elif not batched and isinstance(rhs, BinOp) and rhs.op == "+" \
            and rhs.lhs == Key(t) and rhs.rhs == Const(0.0):
        kind, offset = "prefill", None
    elif not batched and isinstance(rhs, BinOp) and rhs.op == "+" \
            and rhs.lhs == Key(t) and isinstance(rhs.rhs, Param) \
            and out.key_size(t) == 1:
        kind, offset = "decode", rhs.rhs.name
    else:
        return None
    return _AttentionSite(kind=kind, q=j0.left, k=k_scan, v=v_scan,
                          q_col=q_col, k_col=k_col, v_col=v_col,
                          out_col=out_col, head_dim=head_dim, offset=offset)


def _attention_site(node: GroupAgg) -> Optional[_AttentionSite]:
    """``_match_attention``, once per plan node."""
    entry = _ATTENTION_SITES.get(id(node))
    if entry is not None and entry[0]() is node:
        return entry[1]
    key = id(node)
    site = _match_attention(node)
    _ATTENTION_SITES[key] = (
        weakref.ref(node, lambda _: _ATTENTION_SITES.pop(key, None)), site)
    return site


def _identity_page_table(n_seq: int, n_pages: int, device) -> torch.Tensor:
    """Page table [n_seq, n_pages] mapping sequence b's page p to pool page
    ``b·n_pages + p``: a contiguous cache viewed as a pool.  Made once per
    shape and device."""
    k = (n_seq, n_pages, str(device))
    if k not in _PAGE_TABLES:
        _PAGE_TABLES[k] = torch.arange(
            n_seq * n_pages, dtype=torch.int32, device=device).reshape(
                n_seq, n_pages)
    return _PAGE_TABLES[k]


def _try_fused_attention(node: GroupAgg, env, memo, scalars=None):
    """Run a matched attention subplan on one kernel; None if ``node`` is
    not one.

    Decode (single or batched) goes to ``paged_attention``: each cache
    ``[(B,) S, Hkv, d]`` is viewed as a pool of ``page = gcd(S, 64)``-row
    pages with an identity page table, and the lengths are the positions
    + 1 (the batched ones stay on the device: no host sync).  Prefill goes
    to ``flash_attention`` with q ``[1, H, T, d]`` and k/v ``[1, Hkv, S, d]``
    as strided views of the tables.  Both kernels read only the live rows.
    """
    site = _attention_site(node)
    if site is None:
        return None
    qt = execute(site.q, env, memo, scalars)
    kt = execute(site.k, env, memo, scalars)
    vt = execute(site.v, env, memo, scalars)
    d = site.head_dim
    nq, n_heads = qt.key_sizes[0], qt.key_sizes[1]
    q = _unit_inner(qt.cols[site.q_col].reshape(nq, n_heads, d))
    if site.kind == "prefill":
        S, n_kv = kt.key_sizes[:2]

        def heads_first(t):  # [S, Hkv, nc, cs] → [1, Hkv, S, d]
            return _unit_inner(t.reshape(S, n_kv, d)).permute(1, 0, 2)[None]

        res = flash_attention(q.permute(1, 0, 2)[None],
                              heads_first(kt.cols[site.k_col]),
                              heads_first(vt.cols[site.v_col]),
                              causal=True)[0].permute(1, 0, 2)
    else:
        n_seq = nq if site.kind == "batched" else 1
        S, n_kv = kt.key_sizes[-3], kt.key_sizes[-2]
        page = math.gcd(S, 64)

        def pool(t):  # [(B,) S, Hkv, nc, cs] → [B·S/page, page, Hkv, d]
            return _unit_inner(t.reshape(n_seq * S // page, page, n_kv, d))

        if site.kind == "batched":
            lengths = scalars[site.offset] + 1
        else:
            pos = int(scalars[site.offset])
            if not 0 <= pos < S:
                raise IndexError(f"decode position {pos} outside the "
                                 f"{S}-row cache")
            lengths = _arange(S + 1, q.device)[pos + 1:pos + 2]
        res = paged_attention(q, pool(kt.cols[site.k_col]),
                              pool(vt.cols[site.v_col]),
                              _identity_page_table(n_seq, S // page, q.device),
                              lengths)
    out = resolve(node)
    col = res.reshape(tuple(s for _, s in out.keys) + (-1,))
    return DenseTable(keys=out.keys, cols={site.out_col: col},
                      col_types={site.out_col: out.col_type(site.out_col)})


# ---------------------------------------------------------------------------
# Main interpreter
# ---------------------------------------------------------------------------


def execute(node: RelNode, env: Dict[str, DenseTable],
            memo: Optional[Dict[int, DenseTable]] = None,
            scalars: Optional[Dict] = None) -> DenseTable:
    """Execute a relational plan against ``env`` (table name → DenseTable).

    Scan nodes are never memoised (cache tables change between pipeline
    steps); every other node is memoised by identity so shared subplans
    across steps evaluate once.  ``scalars`` holds the runtime parameters:
    Python ints for ``Param`` and int64 device tensors for ``KeyParam``.
    """
    if memo is None:
        memo = {}
    if isinstance(node, Scan):
        if node.table not in env:
            raise KeyError(f"table {node.table!r} not bound in environment")
        t = env[node.table]
        s = node.table_schema
        if t.key_names != s.key_names or tuple(t.cols) != s.col_names:
            # positional re-key: physical table layout matches, names differ
            if t.key_sizes != tuple(sz for _, sz in s.keys):
                raise ValueError(
                    f"table {node.table!r}: stored key sizes {t.key_sizes} "
                    f"!= schema {s.keys}")
            cols = dict(zip(s.col_names, t.cols.values()))
            col_types = {n: t.col_types[o]
                         for n, o in zip(s.col_names, t.cols)}
            t = DenseTable(keys=s.keys, cols=cols, col_types=col_types)
        return t
    if id(node) in memo:
        return memo[id(node)]
    out = _execute(node, env, memo, scalars)
    memo[id(node)] = out
    return out


_REDUCE = {"SUM": torch.sum, "MAX": torch.amax, "MIN": torch.amin,
           "AVG": torch.mean}
_COMPARE = {"<=": torch.le, "<": torch.lt, "==": torch.eq, ">=": torch.ge,
            ">": torch.gt}


def _execute(node: RelNode, env, memo, scalars=None) -> DenseTable:

    if isinstance(node, Project):
        t = execute(node.input, env, memo, scalars)
        schema = resolve(node)
        cols, col_types = {}, {}
        for (cname, _, e), (_, ctype) in zip(node.exprs, schema.cols):
            arr, vec = _eval_expr(e, t)
            full = t.key_sizes + ((arr.shape[-1],) if vec else ())
            arr = _full(arr, full, t.device)
            if node.keys is not None:
                arr = _apply_key_remap(arr, t.keys, node.keys)
            cols[cname] = arr
            col_types[cname] = ctype
        return DenseTable(keys=schema.keys, cols=cols, col_types=col_types)

    if isinstance(node, Join):
        left = execute(node.left, env, memo, scalars)
        right = execute(node.right, env, memo, scalars)
        schema = resolve(node)
        out_cols, out_types = {}, {}
        surv = [(k, s) for k, s in right.keys if k not in dict(node.on)]
        pad = (1,) * len(surv)
        for cname in left.cols:
            arr = left.cols[cname]
            if is_vec(left.col_types[cname]):
                arr = arr.reshape(left.key_sizes + pad + (arr.shape[-1],))
            else:
                arr = torch.broadcast_to(arr, left.key_sizes).reshape(
                    left.key_sizes + pad)
            out_cols[cname] = arr
            out_types[cname] = left.col_types[cname]
        for cname in right.cols:
            oname = cname if cname not in out_cols else cname + "_r"
            out_cols[oname] = _gather_right(left, right, node.on, cname)
            out_types[oname] = right.col_types[cname]
        # columns stay at their own (broadcastable) shapes: the consumers
        # (_eval_expr / reductions) broadcast them to the full key space
        return DenseTable(keys=schema.keys, cols=out_cols, col_types=out_types)

    if isinstance(node, GroupAgg):
        fused = _try_fused_attention(node, env, memo, scalars)
        if fused is None:
            fused = _try_fused_join_agg(node, env, memo, scalars)
        if fused is not None:
            return fused
        t = execute(node.input, env, memo, scalars)
        schema = resolve(node)
        consumed = tuple(i for i, (k, _) in enumerate(t.keys)
                         if k not in node.group_keys)
        cols, col_types = {}, {}
        for (out, fn, e), (_, ctype) in zip(node.aggs, schema.cols):
            arr, vec = _eval_expr(e, t)
            full = t.key_sizes + ((arr.shape[-1],) if vec else ())
            arr = _full(arr, full, t.device)
            # an empty dim tuple means "all dims" to torch: no reduction here
            cols[out] = _REDUCE[fn](arr, dim=consumed) if consumed else arr
            col_types[out] = ctype
        return DenseTable(keys=schema.keys, cols=cols, col_types=col_types)

    if isinstance(node, Filter):
        t = execute(node.input, env, memo, scalars)
        op, lhs, rhs = node.predicate
        dev = t.device

        def side(e):
            v = _eval_key_expr(e, t.key_names, t.key_sizes,
                               lambda n: _arange(n, dev), scalars)
            return v if isinstance(v, torch.Tensor) else torch.tensor(
                v, dtype=torch.int64, device=dev)

        mask = torch.broadcast_to(_COMPARE[op](side(lhs), side(rhs)),
                                  t.key_sizes)
        cols, col_types = {}, {}
        for c, arr in t.cols.items():
            vec = is_vec(t.col_types[c])
            m = mask[..., None] if vec else mask
            full = t.key_sizes + ((arr.shape[-1],) if vec else ())
            cols[c] = torch.where(m, torch.broadcast_to(arr, full),
                                  node.masked_value)
            col_types[c] = t.col_types[c]
        return DenseTable(keys=t.keys, cols=cols, col_types=col_types)

    if isinstance(node, Unnest):
        t = execute(node.input, env, memo, scalars)
        schema = resolve(node)
        varr = t.cols[node.vec_col]
        cols = {node.elem_col: varr}
        col_types = {node.elem_col: SCALAR}
        for c, arr in t.cols.items():
            if c == node.vec_col:
                continue
            cols[c] = torch.broadcast_to(
                arr[..., None], t.key_sizes + (varr.shape[-1],))
            col_types[c] = t.col_types[c]
        return DenseTable(keys=schema.keys, cols=cols, col_types=col_types)

    if isinstance(node, Collect):
        t = execute(node.input, env, memo, scalars)
        schema = resolve(node)
        ax = t.key_names.index(node.fold_key)
        arr = torch.broadcast_to(t.cols[node.scalar_col], t.key_sizes)
        cols = {node.vec_col: torch.movedim(arr, ax, -1)}
        col_types = {node.vec_col: schema.col_type(node.vec_col)}
        for c, a in t.cols.items():
            if c == node.scalar_col:
                continue
            # other scalar columns must be constant along the folded key;
            # take index 0 (used for carrying row ids through collects)
            cols[c] = torch.broadcast_to(a, t.key_sizes).select(ax, 0)
            col_types[c] = t.col_types[c]
        return DenseTable(keys=schema.keys, cols=cols, col_types=col_types)

    raise TypeError(node)
