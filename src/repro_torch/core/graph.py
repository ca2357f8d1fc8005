"""Neural computational-graph IR (ONNX-like) — compiler input (paper §3.2).

The paper consumes a topologically sorted ONNX graph.  ONNX itself is not
available offline, so we define an equivalent lightweight IR: ``Node``s with
an operator type, named inputs/outputs, attributes, and shape/dtype
annotations; ``Graph`` holds nodes in topological order plus initialisers
(weights) and graph inputs/outputs.

Operator vocabulary (the subset exercised by Llama-family inference, per the
paper's Appendix C, plus free-dimension manipulations):

  embedding           ids → rows of the vocabulary table            (gather)
  rmsnorm             x[, weight] → normalised x                    (γ + π)
  layernorm           x[, weight, bias] → normalised x              (γ + π)
  linear              x @ Wᵀ against a chunked weight table         (⋈ + γ)
  rope                rotary positional encoding                    (split/rotate/concat)
  attn_scores         softmax-ready QKᵀ/√d with GQA head-group join (⋈ + γ + π)
  causal_mask         filter t' ≤ t (+offset)                       (σ filter)
  softmax             row-stochastic over t'                        (γ + π)
  attn_output         scores @ V                                    (⋈ + γ)
  silu | gelu | sigmoid | exp | neg | sqrt | rsqrt  — elementwise unary (π)
  add | sub | mul | div                              — elementwise binary (⋈ + π)
  scale               multiply by compile-time scalar               (π)
  split_heads         (t, d) → (t, h, d_head)        free-dim remap (π)
  merge_heads         (t, h, d_head) → (t, d)        free-dim remap (π)
  reshape | squeeze | expand                         free-dim remap (π, fused away)
  concat_rows         append rows to a cache table   (INSERT / cache update)
  identity            pass-through (target of fused shape ops)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

ELEMENTWISE_UNARY = {"silu", "gelu", "sigmoid", "exp", "neg", "sqrt", "rsqrt", "identity"}
ELEMENTWISE_BINARY = {"add", "sub", "mul", "div"}
SHAPE_OPS = {"reshape", "squeeze", "expand", "split_heads", "merge_heads"}


@dataclasses.dataclass
class TensorInfo:
    """Shape/dtype annotation attached during pre-processing (§3.2).

    ``dims`` are named logical dimensions, e.g. ("t", "d") for a [T, D]
    activation.  Free/shared dimension classification (Def. 2.1) is done per
    consuming operator against these names.
    """

    name: str
    dims: Tuple[Tuple[str, int], ...]  # ((dim_name, size), ...)
    dtype: str = "f32"

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(s for _, s in self.dims)

    @property
    def dim_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.dims)

    def size(self, dim_name: str) -> int:
        for n, s in self.dims:
            if n == dim_name:
                return s
        raise KeyError(f"{self.name} has no dim {dim_name!r}")


@dataclasses.dataclass
class Node:
    op: str
    name: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Graph:
    """Topologically sorted computational graph."""

    name: str
    nodes: List[Node] = dataclasses.field(default_factory=list)
    # weight name -> numpy initialiser (or None when bound lazily at runtime)
    initializers: Dict[str, Optional[np.ndarray]] = dataclasses.field(default_factory=dict)
    inputs: List[str] = dataclasses.field(default_factory=list)
    outputs: List[str] = dataclasses.field(default_factory=list)
    tensor_info: Dict[str, TensorInfo] = dataclasses.field(default_factory=dict)
    constants: Dict[str, float] = dataclasses.field(default_factory=dict)

    _counter: int = 0

    def fresh(self, prefix: str) -> str:
        self._counter += 1
        return f"{prefix}_{self._counter}"

    def add(self, op: str, inputs: Sequence[str], output: str | None = None,
            **attrs: Any) -> str:
        out = output or self.fresh(op)
        self.nodes.append(Node(op=op, name=self.fresh(f"n_{op}"),
                               inputs=list(inputs), outputs=[out], attrs=attrs))
        return out

    def annotate(self, name: str, dims: Sequence[Tuple[str, int]],
                 dtype: str = "f32") -> None:
        self.tensor_info[name] = TensorInfo(name=name, dims=tuple(dims), dtype=dtype)

    def info(self, name: str) -> TensorInfo:
        return self.tensor_info[name]

    def producers(self) -> Dict[str, Node]:
        out: Dict[str, Node] = {}
        for n in self.nodes:
            for o in n.outputs:
                out[o] = n
        return out

    def consumers(self) -> Dict[str, List[Node]]:
        out: Dict[str, List[Node]] = {}
        for n in self.nodes:
            for i in n.inputs:
                out.setdefault(i, []).append(n)
        return out

    def toposort_check(self) -> None:
        """Validate the topological invariant the compiler relies on."""
        seen = set(self.inputs) | set(self.initializers) | set(self.constants)
        for n in self.nodes:
            for i in n.inputs:
                if i not in seen:
                    raise ValueError(
                        f"graph {self.name}: node {n.name} consumes {i!r} "
                        "before it is produced (not topologically sorted)")
            seen.update(n.outputs)
        for o in self.outputs:
            if o not in seen:
                raise ValueError(f"graph output {o!r} never produced")


def infer_shapes(graph: Graph) -> None:
    """Shape-annotation pass (§3.2): propagate TensorInfo through every node.

    Inputs and initialisers must already be annotated; this fills in the
    intermediate tensors so stage-1 mapping can classify free/shared dims.
    """
    ti = graph.tensor_info
    for node in graph.nodes:
        op = node.op
        ins = [ti[i] for i in node.inputs if i in ti]
        out = node.outputs[0]
        if out in ti:
            continue
        if op in ELEMENTWISE_UNARY or op == "scale" or op == "causal_mask":
            graph.annotate(out, ins[0].dims, ins[0].dtype)
        elif op in ELEMENTWISE_BINARY:
            # broadcast: prefer the higher-rank operand's dims
            big = max(ins, key=lambda t: len(t.dims))
            graph.annotate(out, big.dims, big.dtype)
        elif op == "embedding":
            tbl, ids = ins
            graph.annotate(out, ids.dims + (tbl.dims[-1],))
        elif op in ("rmsnorm", "layernorm", "rope", "softmax"):
            graph.annotate(out, ins[0].dims, ins[0].dtype)
        elif op == "linear":
            x, w = ins
            graph.annotate(out, x.dims[:-1] + (w.dims[0],))
        elif op == "linear_heads":
            x, w = ins
            graph.annotate(out, x.dims[:-1] + (w.dims[0], w.dims[1]))
        elif op == "rename":
            ren = dict(node.attrs.get("mapping", {}))
            graph.annotate(out, tuple((ren.get(n, n), s)
                                      for n, s in ins[0].dims))
        elif op == "attn_scores":
            q, k = ins
            h = ("h", node.attrs["n_heads"])
            if k.dims[0][0] == q.dims[0][0]:
                # batched decode: both sides share the sequence dim; the
                # cache's position dim is the K side's second dim
                kp = k.dims[1]
            else:
                kp = (k.dims[0][0] + "p", k.dims[0][1])
            graph.annotate(out, (q.dims[0], h, kp))
        elif op == "attn_output":
            s, v = ins
            graph.annotate(out, (s.dims[0], s.dims[1], v.dims[-1]))
        elif op == "split_heads":
            (t, d) = ins[0].dims[0], ins[0].dims[-1]
            n_heads = node.attrs["n_heads"]
            graph.annotate(out, (t, ("h", n_heads), ("dh", d[1] // n_heads)))
        elif op == "merge_heads":
            t, h, dh = ins[0].dims
            graph.annotate(out, (t, ("d", h[1] * dh[1])))
        elif op == "concat_rows":
            new = ins[-1]
            if node.attrs.get("seq_key"):
                # batched decode cache: the sequence key leads, each seq's
                # single new row lands at its own position in the tp domain
                graph.annotate(out, (new.dims[0],
                                     ("tp", node.attrs["cache_len"]))
                               + new.dims[1:])
            else:
                graph.annotate(out,
                               ((new.dims[0][0], node.attrs["cache_len"]),)
                               + new.dims[1:])
        elif op in SHAPE_OPS:
            graph.annotate(out, tuple(node.attrs["dims"]))
        else:
            raise NotImplementedError(f"shape inference for op {op!r}")
