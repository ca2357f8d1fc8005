"""Stage 1 — operator mapping: neural operators → relational functions.

Implements Defs. 2.1–2.3: each neural operator
``F({O_i}, {fd_i}, S)`` is rewritten as a relational function
``R({R_i}, {keys_i}, keys_join)`` over chunked tables, composed from
π / ⋈ / γ / σ / UNNEST / collect_as_array.

Activation layout conventions (mirrors the paper's Appendix A schemas):

  chunked table   keys (..., c) + vec column        e.g. x(t, c, v FLOAT[cs])
  per-head table  keys (t, h, c) + vec              Q/K/V activations
  score table     keys (t, h, tp) + scalar column   QKᵀ relation
  weight tables   W(j, c, chunk) / W(h, r, c, chunk) / norm(c, chunk) /
                  vocabulary(tok, c, chunk) / freq(t, fr, fi)  — Appendix A

The compiler walks the (topologically sorted, shape-annotated) neural graph
and emits a ``RelPipeline``: an ordered list of bind/append steps, one per
neural operator, exactly as §3.3 describes ("a directed acyclic graph of
relational functions").  KV-cache construction (§3.4) appears as append
steps targeting cache tables.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core import relational as ra
from repro_torch.core.graph import Graph, Node
from repro_torch.core.relational import (
    Collect, Filter, GroupAgg, Join, KeyParam, Param, Project, RelNode,
    RelSchema, Scan, Unnest, add, call, col, const, div, floordiv, key, mod,
    mul, sub, SCALAR, VEC,
)

NEG_INF = -1e30

# Physical key orders a KV-cache table ``(pos, head, chunk)`` may be stored
# in — the cache-layout vocabulary shared by the compiler (which owns the
# cache-table convention) and the layout planner (which picks among them):
# each entry permutes the seed key order (pos, head, chunk).
CACHE_KEY_ORDERS: Dict[str, Tuple[int, int, int]] = {
    "row_chunk": (0, 1, 2),   # (tp, hk, c) — seed, append-contiguous
    "head_major": (1, 0, 2),  # (hk, tp, c) — per-head history contiguous
    "pos_major": (0, 2, 1),   # (tp, c, hk) — head-innermost (GQA gather)
}


@dataclasses.dataclass
class Rel:
    """A compiled tensor: relational plan + physical layout."""

    plan: RelNode
    kind: str  # "chunked" | "scalar"
    keys: Tuple[Tuple[str, int], ...]  # logical keys EXCLUDING the chunk key
    col: str = "v"
    chunk: int = 0  # chunk size (chunked kind)
    width: int = 0  # true (unpadded) width of the chunked dimension

    @property
    def n_chunks(self) -> int:
        return max(1, math.ceil(self.width / self.chunk))


@dataclasses.dataclass
class Step:
    kind: str  # "bind" | "append"
    name: str  # tensor name (bind) or target table (append)
    rel: Rel
    offset_name: Optional[str] = None  # append: scalar giving insert position
    append_key: Optional[str] = None   # append: cache key receiving new rows
    # batched append: the sequence key of the cache table.  When set, the
    # offset scalar is a per-sequence position *vector* and each sequence's
    # new row is inserted at (seq, offset[seq]) instead of one shared offset.
    seq_key: Optional[str] = None


@dataclasses.dataclass
class RelPipeline:
    name: str
    steps: List[Step]
    outputs: List[str]
    weight_schemas: Dict[str, RelSchema]
    input_schemas: Dict[str, RelSchema]
    bindings: Dict[str, Rel]
    chunk_size: int
    # physical-layout planning results (filled by
    # repro_torch.planner.plan_layouts):
    # table name -> "row_chunk" | "col_chunk" | "col_chunk_heads" | a cache
    # layout name, plus the full LayoutPlan
    layouts: Dict[str, str] = dataclasses.field(default_factory=dict)
    layout_plan: Optional[object] = None
    # sharded-execution plan (repro_torch.planner.shard.ShardPlan, filled by
    # plan_layouts(shards=N)): per-step shard decisions with per-shard
    # plan copies; None means unsharded execution (the strict default)
    shard_plan: Optional[object] = None
    # planner-chosen physical chunk sizes, table name -> chunk (filled by
    # plan_layouts under chunk_mode="auto"; tables absent here keep the
    # pipeline chunking)
    table_chunks: Dict[str, int] = dataclasses.field(default_factory=dict)
    # planner-chosen payload precisions: *quantised* table name -> codec
    # name (filled by plan_layouts under precision_mode != "off"; tables
    # absent here store f32 payloads).  sqlgen keys DDL dtypes and the
    # "precision:" annotation off this map.
    table_precisions: Dict[str, str] = dataclasses.field(
        default_factory=dict)
    # append-target cache tables: name -> append (position) key.  Filled by
    # map_concat_rows so the layout planner can find cache sites without
    # re-deriving them from the step list.
    cache_tables: Dict[str, str] = dataclasses.field(default_factory=dict)
    # batched pipelines: name of the sequence key threaded through every
    # activation/cache table (None for single-sequence pipelines)
    seq_key: Optional[str] = None


def _scan(name: str, keys, cols) -> Scan:
    return Scan(table=name, table_schema=RelSchema(keys=tuple(keys),
                                                   cols=tuple(cols)))


def _identity_on(keys) -> List[Tuple[str, ra.Expr]]:
    return [(k, key(k)) for k, _ in keys]


class RelCompiler:
    """Walks a neural graph and emits the relational pipeline (stage 1)."""

    def __init__(self, graph: Graph, chunk_size: int = 128):
        self.g = graph
        self.cs = chunk_size
        self.bind: Dict[str, Rel] = {}
        self.steps: List[Step] = []
        self.weight_schemas: Dict[str, RelSchema] = {}
        self.input_schemas: Dict[str, RelSchema] = {}
        self.cache_tables: Dict[str, str] = {}
        self.seq_key: Optional[str] = None

    # -- helpers ------------------------------------------------------------

    def _eff(self, width: int) -> int:
        """Effective chunk size for a dimension (tables narrower than the
        global chunk size use one whole-width chunk, per-table chunk sizes
        being a degree of freedom the paper's §2.1 allows)."""
        eff = min(self.cs, width)
        if width % eff != 0:
            raise ValueError(
                f"dimension {width} not divisible by chunk size {eff}; "
                "pick a chunk size dividing the model dims")
        return eff

    def _chunks(self, width: int) -> int:
        return width // self._eff(width)

    def _emit(self, name: str, rel: Rel) -> Rel:
        self.bind[name] = rel
        self.steps.append(Step(kind="bind", name=name, rel=rel))
        return rel

    def _weight_scan(self, name: str, keys, vec_width: int) -> Scan:
        cols = (("chunk", VEC(vec_width)),)
        sc = _scan(name, keys, cols)
        self.weight_schemas[name] = sc.table_schema
        return sc

    def _rechunk_scalar(self, plan: RelNode, keys, fold_name: str,
                        fold_size: int, scalar_col: str) -> RelNode:
        """(keys..., fold) scalar → (keys..., c) chunked: split + collect."""
        cs = self._eff(fold_size)
        nch = fold_size // cs
        p = Project(
            input=plan,
            keys=[(k, s, key(k)) for k, s in keys]
            + [("c", nch, floordiv(key(fold_name), const(cs))),
               ("e", cs, mod(key(fold_name), const(cs)))],
            exprs=[("x", None, col(scalar_col))],
        )
        return Collect(input=p, fold_key="e", scalar_col="x", vec_col="v")

    def _unchunk(self, rel: Rel) -> Tuple[RelNode, Tuple[Tuple[str, int], ...]]:
        """chunked (keys..., c) vec → (keys..., d) scalar rows via UNNEST."""
        u = Unnest(input=rel.plan, vec_col=rel.col, elem_key="e", elem_col="x")
        nch, cs = rel.n_chunks, rel.chunk
        p = Project(
            input=u,
            keys=[(k, s, key(k)) for k, s in rel.keys]
            + [("d", nch * cs, add(mul(key("c"), const(cs)), key("e")))],
            exprs=[("x", None, col("x"))],
        )
        return p, rel.keys + (("d", nch * cs),)

    # -- operator rules (Def. 2.3: op_map) -----------------------------------

    def map_embedding(self, node: Node) -> Rel:
        tbl_name, ids_name = node.inputs
        ti = self.g.info(node.outputs[0])
        t_dim = self.g.info(ids_name).dims[0]
        d = ti.dims[-1][1]
        vocab = self.g.info(tbl_name).dims[0][1]
        tbl = self._weight_scan(tbl_name, (("tok", vocab),
                                           ("c", self._chunks(d))),
                                vec_width=self._eff(d))
        ids = _scan(ids_name, (t_dim,), (("s", SCALAR),))
        self.input_schemas[ids_name] = ids.table_schema
        j = Join(left=ids, right=tbl, on=[("tok", col("s"))])
        p = Project(input=j, keys=None, exprs=[("v", None, col("chunk"))])
        return Rel(plan=p, kind="chunked", keys=(t_dim,),
                   chunk=self._eff(d), width=d)

    def map_rmsnorm(self, node: Node) -> Rel:
        x = self.bind[node.inputs[0]]
        eps = node.attrs.get("eps", 1e-6)
        d = x.width
        gk = [k for k, _ in x.keys]
        ss = GroupAgg(input=x.plan, group_keys=gk,
                      aggs=[("ss", "SUM", call("dot", col(x.col), col(x.col)))])
        rs = Project(input=ss, keys=None, exprs=[
            ("rs", None, call("rsqrt", add(div(col("ss"), const(d)),
                                           const(eps))))])
        j = Join(left=x.plan, right=rs, on=_identity_on(x.keys))
        out_expr = mul(col(x.col), col("rs"))
        if len(node.inputs) > 1 and node.inputs[1]:
            w = self._weight_scan(node.inputs[1], (("c", x.n_chunks),),
                                  vec_width=x.chunk)
            j = Join(left=j, right=w, on=[("c", key("c"))])
            out_expr = mul(out_expr, col("chunk"))
        p = Project(input=j, keys=None, exprs=[("v", None, out_expr)])
        return Rel(plan=p, kind="chunked", keys=x.keys, chunk=x.chunk,
                   width=x.width)

    def map_layernorm(self, node: Node) -> Rel:
        x = self.bind[node.inputs[0]]
        eps = node.attrs.get("eps", 1e-5)
        d = x.width
        assert d % self.cs == 0, "layernorm requires chunk-aligned width"
        gk = [k for k, _ in x.keys]
        mu = GroupAgg(input=x.plan, group_keys=gk,
                      aggs=[("mu", "SUM", div(call("vsum", col(x.col)),
                                              const(d)))])
        jc = Join(left=x.plan, right=mu, on=_identity_on(x.keys))
        cen = Project(input=jc, keys=None,
                      exprs=[("v", None, sub(col(x.col), col("mu")))])
        ss = GroupAgg(input=cen, group_keys=gk,
                      aggs=[("ss", "SUM", call("dot", col("v"), col("v")))])
        rs = Project(input=ss, keys=None, exprs=[
            ("rs", None, call("rsqrt", add(div(col("ss"), const(d)),
                                           const(eps))))])
        j = Join(left=cen, right=rs, on=_identity_on(x.keys))
        out = mul(col("v"), col("rs"))
        if len(node.inputs) > 1 and node.inputs[1]:
            w = self._weight_scan(node.inputs[1], (("c", x.n_chunks),),
                                  vec_width=x.chunk)
            j = Join(left=j, right=w, on=[("c", key("c"))])
            out = mul(out, col("chunk"))
        if len(node.inputs) > 2 and node.inputs[2]:
            b = self._weight_scan(node.inputs[2], (("c", x.n_chunks),),
                                  vec_width=x.chunk)
            b_sc = Project(input=b, keys=None,
                           exprs=[("bias", None, col("chunk"))])
            j = Join(left=j, right=b_sc, on=[("c", key("c"))])
            out = add(out, col("bias"))
        p = Project(input=j, keys=None, exprs=[("v", None, out)])
        return Rel(plan=p, kind="chunked", keys=x.keys, chunk=x.chunk,
                   width=x.width)

    def map_linear(self, node: Node) -> Rel:
        """C = X Wᵀ  ≡  γ_{(t,j), SUM(dot)}(R_X ⋈_c R_W)  (paper §2.2)."""
        x = self.bind[node.inputs[0]]
        out_f = node.attrs["out_features"]
        w = self._weight_scan(node.inputs[1],
                              (("j", out_f), ("c", x.n_chunks)),
                              vec_width=x.chunk)
        j = Join(left=x.plan, right=w, on=[("c", key("c"))])
        gk = [k for k, _ in x.keys] + ["j"]
        agg = GroupAgg(input=j, group_keys=gk,
                       aggs=[("s", "SUM", call("dot", col(x.col),
                                               col("chunk")))])
        plan = self._rechunk_scalar(agg, x.keys, "j", out_f, "s")
        return Rel(plan=plan, kind="chunked", keys=x.keys,
                   chunk=self._eff(out_f), width=out_f)

    def map_linear_heads(self, node: Node) -> Rel:
        """Per-head projection against W(h, r, c, chunk) — Appendix A layout.

        Output: (t, h, c) chunked over the head dim.
        """
        x = self.bind[node.inputs[0]]
        n_heads = node.attrs["n_heads"]
        dh = node.attrs["head_dim"]
        hname = node.attrs.get("head_key", "h")
        w = self._weight_scan(node.inputs[1],
                              ((hname, n_heads), ("r", dh),
                               ("c", x.n_chunks)),
                              vec_width=x.chunk)
        j = Join(left=x.plan, right=w, on=[("c", key("c"))])
        gk = [k for k, _ in x.keys] + [hname, "r"]
        agg = GroupAgg(input=j, group_keys=gk,
                       aggs=[("s", "SUM", call("dot", col(x.col),
                                               col("chunk")))])
        keys = x.keys + ((hname, n_heads),)
        plan = self._rechunk_scalar(agg, keys, "r", dh, "s")
        return Rel(plan=plan, kind="chunked", keys=keys,
                   chunk=self._eff(dh), width=dh)

    def map_rope(self, node: Node) -> Rel:
        """Rotary encoding: complex split → rotate → concat (paper Tab. 2)."""
        x = self.bind[node.inputs[0]]
        freq_name = node.inputs[1]
        dh = x.width
        t_dim = x.keys[0]
        assert dh % 2 == 0
        freqs = _scan(freq_name, (t_dim,),
                      (("fr", VEC(dh // 2)), ("fi", VEC(dh // 2))))
        self.input_schemas[freq_name] = freqs.table_schema

        # unnest chunks → full head vector (collect_as_array), split halves
        up, keys_d = self._unchunk(x)
        full = Collect(input=up, fold_key="d", scalar_col="x", vec_col="xf")
        halves = Project(input=full, keys=None, exprs=[
            ("x1", None, call("first_half", col("xf"))),
            ("x2", None, call("second_half", col("xf")))])
        j = Join(left=halves, right=freqs, on=[(t_dim[0], key(t_dim[0]))])
        rot = Project(input=j, keys=None, exprs=[
            ("vfull", None, call(
                "concat",
                sub(mul(col("x1"), col("fr")), mul(col("x2"), col("fi"))),
                add(mul(col("x1"), col("fi")), mul(col("x2"), col("fr"))))),
        ])
        # re-chunk to (t, h, c)
        u2 = Unnest(input=rot, vec_col="vfull", elem_key="d2", elem_col="x")
        plan = self._rechunk_scalar(u2, x.keys, "d2", dh, "x")
        return Rel(plan=plan, kind="chunked", keys=x.keys,
                   chunk=self._eff(dh), width=dh)

    def map_rename(self, node: Node) -> Rel:
        """Key/column renaming π (e.g. K activations t→tp, v→kv before the
        cache, so the attention join's two sides have distinct columns)."""
        x = self.bind[node.inputs[0]]
        ren = dict(node.attrs.get("mapping", {}))  # old key -> new key
        new_col = node.attrs.get("col_rename", x.col)
        new_keys = tuple((ren.get(k, k), s) for k, s in x.keys)
        p = Project(
            input=x.plan,
            keys=[(ren.get(k, k), s, key(k)) for k, s in x.keys]
            + ([("c", x.n_chunks, key("c"))] if x.kind == "chunked" else []),
            exprs=[(new_col, None, col(x.col))])
        return Rel(plan=p, kind=x.kind, keys=new_keys, col=new_col,
                   chunk=x.chunk, width=x.width)

    def map_attn_scores(self, node: Node) -> Rel:
        """A = QKᵀ/√d with the GQA head-group join  (paper Tab. 2:
        ``ON Q.row = K.row AND Q.head // g = K.head``)."""
        q = self.bind[node.inputs[0]]
        k_ = self.bind[node.inputs[1]]
        n_heads = node.attrs["n_heads"]
        n_kv = node.attrs["n_kv"]
        dh = node.attrs["head_dim"]
        g = n_heads // n_kv
        t_dim = q.keys[0]
        on = []
        if k_.keys[0][0] == t_dim[0]:
            # batched decode: the cache carries the sequence key — each
            # query row joins only its own sequence's cached history
            on.append((t_dim[0], key(t_dim[0])))
            tp_dim = k_.keys[1]
        else:
            tp_dim = k_.keys[0]
        on += [("hk", floordiv(key("h"), const(g))), ("c", key("c"))]
        j = Join(left=q.plan, right=k_.plan, on=on)
        agg = GroupAgg(
            input=j, group_keys=[t_dim[0], "h", tp_dim[0]],
            aggs=[("s", "SUM", call("scale", call("dot", col(q.col),
                                                  col(k_.col)),
                                    const(1.0 / math.sqrt(dh))))])
        return Rel(plan=agg, kind="scalar",
                   keys=(t_dim, ("h", n_heads), tp_dim), col="s")

    def map_causal_mask(self, node: Node) -> Rel:
        s = self.bind[node.inputs[0]]
        t_name = s.keys[0][0]
        tp_name = s.keys[2][0]
        if node.attrs.get("offset_vec_name"):
            # batched decode: each sequence attends up to *its own*
            # position — the bound parameter is a per-sequence vector and
            # the leading key is the sequence key, not a position
            pred = ("<=", key(tp_name),
                    KeyParam(node.attrs["offset_vec_name"], t_name))
        else:
            if node.attrs.get("offset_name"):  # dynamic position (§3.4)
                off = Param(node.attrs["offset_name"])
            else:
                off = const(node.attrs.get("offset", 0))
            pred = ("<=", key(tp_name), add(key(t_name), off))
        f = Filter(input=s.plan, predicate=pred, masked_value=NEG_INF)
        return Rel(plan=f, kind="scalar", keys=s.keys, col=s.col)

    def map_softmax(self, node: Node) -> Rel:
        """Row softmax: γ MAX → π exp → γ SUM → π divide (stabilised
        variant of paper Tab. 2 — same relational shape)."""
        s = self.bind[node.inputs[0]]
        gk = [k for k, _ in s.keys[:-1]]
        m = GroupAgg(input=s.plan, group_keys=gk,
                     aggs=[("m", "MAX", col(s.col))])
        j1 = Join(left=s.plan, right=m, on=_identity_on(s.keys[:-1]))
        e = Project(input=j1, keys=None,
                    exprs=[("ex", None, call("exp", sub(col(s.col),
                                                        col("m"))))])
        z = GroupAgg(input=e, group_keys=gk,
                     aggs=[("z", "SUM", col("ex"))])
        j2 = Join(left=e, right=z, on=_identity_on(s.keys[:-1]))
        p = Project(input=j2, keys=None,
                    exprs=[("p", None, div(col("ex"), col("z")))])
        return Rel(plan=p, kind="scalar", keys=s.keys, col="p")

    def map_attn_output(self, node: Node) -> Rel:
        """S = M V  ≡  γ_{(t,c), SUM(m ⊗ v)}(R_M ⋈_{t'} R_V)  (§2.4)."""
        p = self.bind[node.inputs[0]]
        v = self.bind[node.inputs[1]]
        n_heads = node.attrs["n_heads"]
        n_kv = node.attrs["n_kv"]
        g = n_heads // n_kv
        t_dim = p.keys[0]
        tp_name = p.keys[2][0]
        on = []
        if v.keys[0][0] == t_dim[0]:  # batched: per-sequence cache join
            on.append((t_dim[0], key(t_dim[0])))
        on += [(tp_name, key(tp_name)),
               ("hk", floordiv(key("h"), const(g)))]
        j = Join(left=p.plan, right=v.plan, on=on)
        agg = GroupAgg(input=j, group_keys=[t_dim[0], "h", "c"],
                       aggs=[("v", "SUM", mul(col(p.col), col(v.col)))])
        return Rel(plan=agg, kind="chunked",
                   keys=(t_dim, ("h", n_heads)), chunk=v.chunk, width=v.width)

    def map_merge_heads(self, node: Node) -> Rel:
        """(t, h, c over dh) → (t, c over d): unnest, merge keys, re-chunk."""
        x = self.bind[node.inputs[0]]
        t_dim = x.keys[0]
        n_heads = x.keys[1][1]
        dh = x.width
        d = n_heads * dh
        u = Unnest(input=x.plan, vec_col=x.col, elem_key="e", elem_col="x")
        p1 = Project(
            input=u,
            keys=[(t_dim[0], t_dim[1], key(t_dim[0])),
                  ("r", x.n_chunks * x.chunk,
                   add(mul(key("c"), const(x.chunk)), key("e"))),
                  ("h", n_heads, key("h"))],
            exprs=[("x", None, col("x"))])
        p2 = Project(
            input=p1,
            keys=[(t_dim[0], t_dim[1], key(t_dim[0])),
                  ("d", d, add(mul(key("h"), const(dh)), key("r")))],
            exprs=[("x", None, col("x"))])
        plan = self._rechunk_scalar(p2, (t_dim,), "d", d, "x")
        return Rel(plan=plan, kind="chunked", keys=(t_dim,),
                   chunk=self._eff(d), width=d)

    def map_elementwise_binary(self, node: Node) -> Rel:
        x = self.bind[node.inputs[0]]
        y = self.bind[node.inputs[1]]
        ops = {"add": add, "sub": sub, "mul": mul, "div": div}
        y_col = y.col if y.col != x.col else y.col + "_r"
        y_keys = y.keys + ((("c", y.n_chunks),) if y.kind == "chunked" else ())
        j = Join(left=x.plan, right=y.plan, on=_identity_on(y_keys))
        p = Project(input=j, keys=None,
                    exprs=[(x.col, None, ops[node.op](col(x.col),
                                                      col(y_col)))])
        return Rel(plan=p, kind=x.kind, keys=x.keys, col=x.col, chunk=x.chunk,
                   width=x.width)

    def map_elementwise_unary(self, node: Node) -> Rel:
        x = self.bind[node.inputs[0]]
        p = Project(input=x.plan, keys=None,
                    exprs=[(x.col, None, call(node.op, col(x.col)))])
        return Rel(plan=p, kind=x.kind, keys=x.keys, col=x.col, chunk=x.chunk,
                   width=x.width)

    def map_scale(self, node: Node) -> Rel:
        x = self.bind[node.inputs[0]]
        p = Project(input=x.plan, keys=None,
                    exprs=[(x.col, None,
                            call("scale", col(x.col),
                                 const(node.attrs["value"])))])
        return Rel(plan=p, kind=x.kind, keys=x.keys, col=x.col, chunk=x.chunk,
                   width=x.width)

    def map_concat_rows(self, node: Node) -> Rel:
        """KV-cache append (§3.4): INSERT the new rows into the cache table,
        then the downstream attention scans the cache.

        Batched pipelines (``seq_key`` attr) key the cache by sequence as
        well: the table is ``(seq, tp, …)`` and each sequence's single new
        row is inserted at its *own* position (the offset parameter is a
        per-sequence vector)."""
        cache_name = node.inputs[0]
        new = self.bind[node.inputs[1]]
        cache_len = node.attrs["cache_len"]
        seq_key = node.attrs.get("seq_key")
        if seq_key:
            assert new.keys[0][0] == seq_key, (new.keys, seq_key)
            pos_key = node.attrs.get("append_key", "tp")
            cache_keys = (new.keys[0], (pos_key, cache_len)) + new.keys[1:]
            self.seq_key = seq_key
        else:
            append_key = node.attrs.get("append_key", new.keys[0][0])
            pos_key = (append_key + "p" if not append_key.endswith("p")
                       else append_key)
            cache_keys = ((pos_key, cache_len),) + new.keys[1:]
        sc = _scan(cache_name,
                   tuple(cache_keys) + (("c", new.n_chunks),),
                   ((new.col, VEC(new.chunk)),))
        self.input_schemas[cache_name] = sc.table_schema
        self.cache_tables[cache_name] = pos_key
        self.steps.append(Step(kind="append", name=cache_name, rel=new,
                               offset_name=node.attrs.get("offset_name",
                                                          "cache_position"),
                               append_key=pos_key, seq_key=seq_key))
        return Rel(plan=sc, kind="chunked", keys=tuple(cache_keys),
                   col=new.col, chunk=new.chunk, width=new.width)

    # -- driver ---------------------------------------------------------------

    OP_RULES = {
        "embedding": map_embedding,
        "rmsnorm": map_rmsnorm,
        "layernorm": map_layernorm,
        "linear": map_linear,
        "linear_heads": map_linear_heads,
        "rope": map_rope,
        "rename": map_rename,
        "attn_scores": map_attn_scores,
        "causal_mask": map_causal_mask,
        "softmax": map_softmax,
        "attn_output": map_attn_output,
        "merge_heads": map_merge_heads,
        "scale": map_scale,
        "concat_rows": map_concat_rows,
    }

    def compile(self) -> RelPipeline:
        self.g.toposort_check()
        for node in self.g.nodes:
            if node.op in ("add", "sub", "mul", "div"):
                rel = self.map_elementwise_binary(node)
            elif node.op in ("silu", "gelu", "sigmoid", "exp", "neg", "sqrt",
                             "rsqrt", "identity"):
                rel = self.map_elementwise_unary(node)
            elif node.op in self.OP_RULES:
                rel = self.OP_RULES[node.op](self, node)
            else:
                raise NotImplementedError(
                    f"no operator mapping for {node.op!r} (node {node.name})")
            self._emit(node.outputs[0], rel)
        return RelPipeline(
            name=self.g.name,
            steps=self.steps,
            outputs=list(self.g.outputs),
            weight_schemas=self.weight_schemas,
            input_schemas=self.input_schemas,
            bindings=self.bind,
            chunk_size=self.cs,
            cache_tables=self.cache_tables,
            seq_key=self.seq_key,
        )


def op_map(graph: Graph, chunk_size: int = 128) -> RelPipeline:
    """Def. 2.3 entry point: map a neural graph to relational functions."""
    return RelCompiler(graph, chunk_size=chunk_size).compile()
