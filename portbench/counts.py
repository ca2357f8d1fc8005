"""What every architecture's work counts share: the card's peaks, the
least time of one matrix product, and the keys a run of query tokens
reads.

Nothing here reads a launch shape or a kernel: the same tokens served
count the same work whichever kernel does it.  Each architecture
(``archs/<model>.py``) counts its own FLOPs and least times from these.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

HERE = Path(__file__).resolve().parent


def peaks() -> Dict[str, float]:
    raw = json.loads((HERE / "peaks.json").read_text())
    return {k: v["value"] for k, v in raw.items() if isinstance(v, dict)}


def keys_read(first: int, end: int) -> int:
    """Keys read by query tokens at positions ``first .. end - 1``."""
    return end * (end + 1) // 2 - first * (first + 1) // 2


def matmul_least_s(m: int, n: int, k: int, pk: Dict[str, float]) -> float:
    """``max(2 M N K / flops, 4 (N K + M K + M N) / bandwidth)``: float32
    operands, each read once, the output written once."""
    return max(2 * m * n * k / pk["f32_flops_per_s"],
               4 * (n * k + m * k + m * n) / pk["hbm_bytes_per_s"])
