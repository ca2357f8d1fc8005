"""What a run measured, handed to each metric's reader.

Every metric of ``BENCHMARK.json`` has a reader, ``metrics/<name>.py``,
whose ``read(w)`` takes a :class:`Window` and returns the number, or
``None`` where it finds nothing to read (the metric is then left out of
the line).  The client's records are on the monotonic clock, the
server-side calls and the trace on ``time.time_ns``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import statistics
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Window:
    arch: ModuleType               # archs/<model>.py: the work counts
    shapes: Any                    # arch.shapes(cfg)
    peaks: Dict[str, float]
    seconds: float
    t_open: float                  # client clock (time.monotonic)
    t_close: float
    requests: List[Dict]           # the load generator's records
    setup_s: float
    prefills: List[tuple]          # (start_ns, end_ns, context, cached)
    decodes: List[tuple]           # (start_ns, end_ns, rows, keys)
    edges: Dict[str, Dict]         # the program's counters at both edges
    gate_s: float                  # the server-side window's length
    device: Optional[Dict] = None  # devtrace.reduce(), traced runs only

    def delta(self, counter: str) -> Optional[int]:
        a, b = self.edges.get("open", {}), self.edges.get("close", {})
        if counter not in a or counter not in b:
            return None
        return b[counter] - a[counter]

    def sent_in_window(self) -> List[Dict]:
        return [r for r in self.requests
                if self.t_open <= r["sent"] < self.t_close]

    def in_window(self, t: float) -> bool:
        return self.t_open <= t < self.t_close


def quantile(values: List[float], q: int, n: int = 100) -> float:
    """The ``q``-th of ``n`` quantiles (``statistics.quantiles``,
    inclusive method: the sample's own range)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=n, method="inclusive")[q - 1]


def reader(name: str) -> Callable[[Window], Optional[float]]:
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
