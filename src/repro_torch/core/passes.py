"""Compiler optimisation passes.

Pre-optimisation on the *neural graph* (§3.2):
  - ``constant_fold``     — scalar-producing subgraphs evaluated at compile
                            time and attached as constant attributes.
  - ``eliminate_shape_ops`` — identity / pure free-dimension manipulations
                            are removed and absorbed into their successors'
                            projection primitives.
  - ``dead_code_elim``    — nodes whose outputs are never consumed.

Post-optimisation on the *relational pipeline* (§3.4):
  - ``fuse_projections``  — adjacent π∘π chains composed into one projection
                            (the paper's "merge nodes into CTEs / fuse
                            elementwise operations into a single projection").
  - ``count_nodes``       — CTE count before/after, for the benchmark table.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.graph import Graph, Node, SHAPE_OPS
from repro_torch.core.relational import (
    BinOp, Call, Col, Collect, Const, Expr, Filter, GroupAgg, Join, Key,
    KeyParam, Param, Project, RelNode, Scan, Unnest,
)
from repro_torch.core.opmap import RelPipeline

# ---------------------------------------------------------------------------
# Neural-graph pre-optimisations
# ---------------------------------------------------------------------------

_FOLDABLE = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
}


def constant_fold(graph: Graph) -> int:
    """Evaluate scalar ops whose inputs are all compile-time constants."""
    folded = 0
    new_nodes = []
    for node in graph.nodes:
        if node.op in _FOLDABLE and all(i in graph.constants
                                        for i in node.inputs):
            a, b = (graph.constants[i] for i in node.inputs)
            graph.constants[node.outputs[0]] = _FOLDABLE[node.op](a, b)
            folded += 1
            continue
        if node.op == "scale" and node.inputs[0] in graph.constants:
            graph.constants[node.outputs[0]] = (
                graph.constants[node.inputs[0]] * node.attrs["value"])
            folded += 1
            continue
        new_nodes.append(node)
    graph.nodes = new_nodes
    return folded


def eliminate_shape_ops(graph: Graph) -> int:
    """Drop identity nodes and chain-fuse scale∘scale (free-dim ops that the
    operator-mapper already folds into single projections stay as-is)."""
    removed = 0
    alias: Dict[str, str] = {}
    new_nodes = []
    for node in graph.nodes:
        ins = [alias.get(i, i) for i in node.inputs]
        node = dataclasses.replace(node, inputs=ins)
        if node.op == "identity":
            alias[node.outputs[0]] = node.inputs[0]
            removed += 1
            continue
        new_nodes.append(node)
    graph.nodes = new_nodes
    graph.outputs = [alias.get(o, o) for o in graph.outputs]
    return removed


def dead_code_elim(graph: Graph) -> int:
    """Remove nodes whose outputs are never consumed (reverse sweep)."""
    live = set(graph.outputs)
    keep = []
    for node in reversed(graph.nodes):
        if any(o in live for o in node.outputs):
            keep.append(node)
            live.update(node.inputs)
    removed = len(graph.nodes) - len(keep)
    graph.nodes = list(reversed(keep))
    return removed


def preoptimize(graph: Graph) -> Dict[str, int]:
    stats = {
        "constants_folded": constant_fold(graph),
        "shape_ops_eliminated": eliminate_shape_ops(graph),
        "dead_nodes_removed": dead_code_elim(graph),
    }
    return stats


# ---------------------------------------------------------------------------
# Relational post-optimisations (CTE fusion)
# ---------------------------------------------------------------------------


def _subst(expr: Expr, bindings: Dict[str, Expr]) -> Expr:
    """Substitute Col references by their defining expressions."""
    if isinstance(expr, Col):
        return bindings.get(expr.name, expr)
    if isinstance(expr, (Key, Const, Param, KeyParam)):
        return expr
    if isinstance(expr, BinOp):
        return BinOp(expr.op, _subst(expr.lhs, bindings),
                     _subst(expr.rhs, bindings))
    if isinstance(expr, Call):
        return Call(expr.fn, tuple(_subst(a, bindings) for a in expr.args))
    raise TypeError(expr)


def fuse_projections(root: RelNode, memo: Dict[int, RelNode] | None = None
                     ) -> RelNode:
    """π(π(x)) → π(x) when at most one of the two remaps keys.

    This is the paper's CTE fusion: elementwise steps collapse into a single
    SELECT instead of materialising intermediate relations.
    """
    if memo is None:
        memo = {}
    if id(root) in memo:
        return memo[id(root)]

    node = root
    if not isinstance(node, Scan):
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, RelNode):
                setattr(node, f.name, fuse_projections(v, memo))

    if isinstance(node, Project) and isinstance(node.input, Project):
        inner = node.input
        # only fuse when the inner projection does not remap keys (pure
        # column computation) — key remaps need their own SELECT
        if inner.keys is None:
            bindings = {c: e for c, _, e in inner.exprs}
            try:
                new_exprs = [(c, t, _subst(e, bindings))
                             for c, t, e in node.exprs]
                node = Project(input=inner.input, keys=node.keys,
                               exprs=new_exprs)
                node = fuse_projections(node, memo)
            except TypeError:
                pass

    memo[id(root)] = node
    return node


def postoptimize(pipeline: RelPipeline, layout_mode: str = "off",
                 cost_params=None, cache_mode: str = "off",
                 budget_bytes=None, chunk_mode: str = "off",
                 chunk_candidates=None, table_chunks=None,
                 pool=None, precision_mode: str = "off",
                 table_precisions=None,
                 shards=None) -> Dict[str, int]:
    """Apply relational post-optimisations in place across all steps.

    ``layout_mode`` invokes the physical-layout planner (ROW2COL) as a
    standard post-optimisation stage: ``"off"`` keeps the seed ROW_CHUNK
    plans, ``"auto"`` rewrites matmul sites where the cost model prefers
    the column layout (COL_CHUNK, or head-blocked COL_CHUNK_HEADS for the
    Q/K/V projections), ``"col"`` forces it wherever legal.
    ``cache_mode`` re-keys the KV-cache tables (``"off"`` keeps the seed
    ``(tp, hk, c)`` order, ``"auto"`` is cost-based, or a layout name to
    force); ``budget_bytes`` bounds the duplicate residency of column
    copies (the global residency pass) — pass ``pool`` (a planner
    ``ResidencyPool``) instead to share one budget across pipelines.
    ``chunk_mode="auto"`` makes per-table physical chunk sizes a planner
    decision priced over ``chunk_candidates`` (``table_chunks`` pins
    specific tables to sizes an earlier plan chose).  ``precision_mode``
    makes the stored payload precision a planner decision too — eligible
    weight tables are rewritten to scan quantised twins through inline
    dequant projections (``table_precisions`` pins per-table choices).
    ``shards=N`` (N > 1) runs the sharded-execution pass after every
    other planning stage: eligible matmul sites get per-shard plan copies
    and a combine decision recorded on ``pipeline.shard_plan``
    (``repro_torch.planner.shard``); plans themselves are not rewritten.
    The resulting ``LayoutPlan`` is recorded on ``pipeline.layout_plan``.
    The shard plan runs through ``run_pipeline(shard_runner=)`` with a
    ``repro_torch.serving.shards.ShardWorkerPool``.
    """
    before = count_nodes(pipeline)
    memo: Dict[int, RelNode] = {}
    for step in pipeline.steps:
        step.rel.plan = fuse_projections(step.rel.plan, memo)
    for name, rel in pipeline.bindings.items():
        rel.plan = fuse_projections(rel.plan, memo)
    stats = {"rel_nodes_before": before}
    sharded = bool(shards) and int(shards) > 1
    if layout_mode != "off" or cache_mode != "off" \
            or precision_mode != "off" or sharded:
        from repro_torch.planner import plan_layouts
        plan = plan_layouts(pipeline, mode=layout_mode, params=cost_params,
                            budget_bytes=budget_bytes, cache_mode=cache_mode,
                            chunk_mode=chunk_mode,
                            chunk_candidates=chunk_candidates,
                            table_chunks=table_chunks, pool=pool,
                            precision_mode=precision_mode,
                            table_precisions=table_precisions,
                            shards=shards)
        stats["row2col_sites"] = len(plan.decisions)
        stats["row2col_rewrites"] = len(plan.col_decisions)
        stats["cache_relayouts"] = sum(
            1 for d in plan.cache_decisions if d.layout != "row_chunk")
        stats["chunk_planned_tables"] = len(pipeline.table_chunks)
        stats["quantised_tables"] = len(plan.precision_decisions)
        sp = pipeline.shard_plan
        stats["sharded_sites"] = len(sp.decisions) if sp is not None else 0
    stats["rel_nodes_after"] = count_nodes(pipeline)
    return stats


def count_nodes(pipeline: RelPipeline) -> int:
    """Distinct relational nodes across all steps.  One iterative walk
    shares ``seen`` between steps: each step's plan reaches back through
    every earlier step, so a walk per step is quadratic in depth (seconds
    per 32-layer plan)."""
    seen = set()
    stack = [step.rel.plan for step in pipeline.steps]
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        if not isinstance(n, Scan):
            stack.extend(getattr(n, f.name) for f in dataclasses.fields(n)
                         if isinstance(getattr(n, f.name), RelNode))
    return len(seen)
