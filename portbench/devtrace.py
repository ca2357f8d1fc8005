"""Reduce the profiler's trace of the window to device time.

The traced run profiles CUDA activity only (``torch.profiler``) from the
first call into the engine at or after the window's opening to the first
one at or after its close, so every kernel and copy it records belongs
to the window.  Kineto puts the card's timestamps on the host's
``time.time_ns`` clock, which is how the idle gaps are matched with what
the host was doing (the harness's records of each prefill and decode
call).  Nothing is written to disk.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Sequence, Tuple

import torch


def _ns(ev, name: str) -> int:
    f = getattr(ev, f"{name}_ns", None)
    return int(f()) if f is not None else int(getattr(ev, f"{name}_us")()
                                              * 1000)


def device_events(prof) -> List[Tuple[int, int, str]]:
    """``(start_ns, end_ns, name)`` of every kernel, copy and set on the
    card, from the profiler's raw Kineto events."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != cuda:
            continue
        start = _ns(ev, "start")
        out.append((start, start + int(ev.duration_ns()
                                       if hasattr(ev, "duration_ns")
                                       else ev.duration_us() * 1000),
                    ev.name()))
    return out


def _merge(intervals: Sequence[Tuple[int, int]], lo: int, hi: int
           ) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def short_name(name: str, limit: int = 96) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."


def reduce(events: List[Tuple[int, int, str]], open_ns: int, close_ns: int,
           calls: Sequence[Tuple[str, int, int]]) -> Dict:
    """Busy and idle time of the window ``[open_ns, close_ns)``, device
    seconds by name, and the idle gaps labelled by the host's call
    (``calls``: ``(kind, start_ns, end_ns)`` of each prefill and decode
    call the harness recorded; a gap outside every call is the
    scheduler's loop, the HTTP front end or an idle scheduler)."""
    busy = _merge([(a, b) for a, b, _ in events], open_ns, close_ns)
    by_name: Dict[str, float] = collections.defaultdict(float)
    for a, b, name in events:
        by_name[name] += (b - a) / 1e9
    calls = sorted(calls, key=lambda c: c[1])
    starts = [c[1] for c in calls]

    def host_phase(t: int) -> str:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and calls[i][1] <= t < calls[i][2]:
            return f"host in {calls[i][0]}"
        return "host between calls"

    gaps = []
    edge = open_ns
    for a, b in busy + [(close_ns, close_ns)]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    totals: Dict[str, float] = collections.defaultdict(float)
    labelled = []
    for a, b in gaps:
        label = host_phase((a + b) // 2)
        totals[label] += (b - a) / 1e9
        labelled.append((f"gap, {label}", (b - a) / 1e9))
    labelled.sort(key=lambda g: -g[1])
    idle = sorted(([f"all gaps, {k}", v] for k, v in totals.items()),
                  key=lambda g: -g[1])
    idle += [list(g) for g in labelled[:10 - len(idle)]]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"window_s": (close_ns - open_ns) / 1e9,
            "busy_s": sum(b - a for a, b in busy) / 1e9,
            "by_name": dict(by_name),
            "events": len(events),
            "breakdown": {
                "device_ops": [[short_name(n), s] for n, s in ops[:10]],
                "idle_gaps": idle[:10]}}
