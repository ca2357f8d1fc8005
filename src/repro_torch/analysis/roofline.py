"""Roofline analysis from the dry-run's counted steps.

Three terms per (arch × shape × mesh), in seconds:

    compute    = FLOPs_per_device / peak_FLOPs             (tensor-core bound)
    memory     = bytes_per_device / HBM_bw                 (HBM bound)
    collective = collective_bytes_per_device / link_bw     (NVLink bound)

The dry-run (``launch/dryrun.py``) runs one step eagerly on fake tensors
and counts each rank's local ops: the FLOPs of the matmul, convolution and
attention families (``torch.utils.flop_counter``'s formulas), the bytes
each op reads and writes (views excluded; no fusion), and one record per
collective with its operand bytes.  :func:`collective_bytes` sums those
records by the reference's collective kinds, as the reference sums the
operands of the collectives in its partitioned HLO.

Hardware model (NVIDIA H100 SXM data sheet, at the 700 W limit): 989
TFLOP/s dense bf16, 3.35 TB/s HBM3, 450 GB/s NVLink 4 each way.  The one
link term models every mesh axis as NVLink.  That holds within one node of
8 cards; a 16×16 mesh spans 32 such nodes, and an axis that crosses nodes
runs at the network's rate (about 50 GB/s a card at NDR400 InfiniBand), so
``t_collective`` is a lower bound there.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional

PEAK_FLOPS = 989e12       # dense bf16 per card
HBM_BW = 3.35e12          # bytes/s per card
LINK_BW = 450e9           # bytes/s per card, NVLink 4, each way

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute", "collective-broadcast")

# the counter's op names (namespace stripped) → the reference's kinds:
# DTensor's functional collectives, c10d's in-place ones, and the
# point-to-point send / recv of ``batch_isend_irecv`` as a permute
_KIND_OF = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "reduce_scatter_tensor_out": "reduce-scatter",
    "send": "collective-permute", "recv_": "collective-permute",
    "recv_any_source_": "collective-permute", "isend": "collective-permute",
    "irecv": "collective-permute", "batch_p2p_ops": "collective-permute",
    "broadcast": "collective-broadcast", "broadcast_": "collective-broadcast",
}


def collective_kind(op: str) -> Optional[str]:
    """The reference's kind of a counted op (``"c10d.allreduce_"``,
    ``"_c10d_functional.all_gather_into_tensor"``), or None for an op that
    moves nothing between ranks (``wait_tensor``, ``barrier``, compute)."""
    return _KIND_OF.get(op.rsplit(".", 1)[-1])


def collective_bytes(records: Iterable[Mapping]) -> Dict[str, int]:
    """Sum operand bytes per collective kind from the counter's records
    (``{"op": name, "bytes": operand bytes}``, one a collective call)."""
    out: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
    for r in records:
        kind = collective_kind(r["op"])
        if kind is not None:
            out[kind] += int(r["bytes"])
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    return out


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    coll_breakdown: Dict[str, int]
    model_flops: float                  # 6·N·D (dense) / 6·N_active·D (MoE)
    per_dev_output_bytes: float = 0.0
    compile_seconds: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops_per_dev / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_dev / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_dev / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> Optional[float]:
        """MODEL_FLOPS / (counted FLOPs × chips): how much counted compute
        is 'useful' — catches remat recompute and dispatch overhead."""
        if not self.flops_per_dev:
            return None
        return self.model_flops / max(self.flops_per_dev, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """compute term / bound time — fraction of peak at the bottleneck."""
        bt = self.bound_time
        return self.t_compute / bt if bt else 0.0

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "flops_per_dev": self.flops_per_dev,
            "bytes_per_dev": self.bytes_per_dev,
            "coll_bytes_per_dev": self.coll_bytes_per_dev,
            "model_flops_per_dev": self.model_flops,
            "useful_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "compile_seconds": self.compile_seconds,
        }


def model_flops_for(cfg, shape_info: Dict, n_chips: int, kind: str) -> float:
    """Analytic MODEL_FLOPS per device: 6·N·D train, 2·N·D forward-only
    (per generated token for decode)."""
    n_active = cfg.active_param_count()
    if kind == "train":
        tokens = shape_info["seq_len"] * shape_info["global_batch"]
        return 6.0 * n_active * tokens / n_chips
    if kind == "prefill":
        tokens = shape_info["seq_len"] * shape_info["global_batch"]
        return 2.0 * n_active * tokens / n_chips
    tokens = shape_info["global_batch"]  # decode: 1 token per sequence
    return 2.0 * n_active * tokens / n_chips


def format_table(rows: List[Dict]) -> str:
    hdr = ("| arch | shape | mesh | t_comp (s) | t_mem (s) | t_coll (s) | "
           "bound | MODEL/HLO | roofline frac |")
    sep = "|" + "---|" * 9
    lines = [hdr, sep]
    for r in rows:
        ur = r["useful_ratio"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['t_compute_s']:.3e} | {r['t_memory_s']:.3e} "
            f"| {r['t_collective_s']:.3e} | {r['bottleneck']} "
            f"| {ur:.2f} | {r['roofline_fraction']:.2%} |"
            if ur is not None else
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | - | - | - | - | - | - |")
    return "\n".join(lines)
