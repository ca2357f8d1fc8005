"""Name each idle instant of the card inside an engine call by the
program's own spans.

A traced run's profile gives the card's busy intervals (``devtrace``);
the program's tracer gives its spans, each with its thread, on the same
``time.time_ns`` clock (``repro_torch.obs.trace``).  Every instant of
the window at which the card is idle and the scheduler thread is inside
one of the harness's recorded prefill or decode calls takes a name:

- ``gc`` while any thread's ``gc`` span is open (every thread stops in a
  collection, so it overrides every other span);
- else by the scheduler thread's innermost open span: ``dispatch`` for a
  ``step`` or ``op`` span (the host issuing the model's work), ``pager``
  for the pager's miss path, ``decoder`` for the decoder's phases
  (``session_env``, the cache gathers and writes, ``device_wait`` on the
  logits);
- ``unnamed`` where no such span is open, or the innermost is of another
  category.

Other threads' spans (the pager's prefetch thread) name nothing.  The
names of a call kind add up to the idle time the harness labels ``host
in <kind>``.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.obs.trace import CAT, DUR, TID, TS

NAMES = ("dispatch", "pager", "decoder", "gc", "unnamed")
_BY_CAT = {"step": "dispatch", "op": "dispatch", "pager": "pager",
           "decoder": "decoder"}

# a span: (start_ns, end_ns, cat, tid)
Span = Tuple[int, int, str, int]


def window_spans(ticks, epoch_ns: int, first_seq: int) -> List[Span]:
    """The spans of the flight recorder's ticks from sequence number
    ``first_seq`` on (the window's first call), as absolute ``(start_ns,
    end_ns, cat, tid)``.  Raises if the ring dropped a tick of the window
    (its oldest retained tick comes after ``first_seq``)."""
    mine = [t for t in ticks if t.seq >= first_seq]
    if not mine or min(t.seq for t in mine) != first_seq:
        raise RuntimeError(
            f"the flight ring dropped ticks of the window: first kept "
            f"{min((t.seq for t in mine), default=None)}, window starts "
            f"at {first_seq}")
    out = []
    for t in mine:
        for r in t.records:
            a = epoch_ns + round(r[TS] * 1e3)
            out.append((a, a + round(r[DUR] * 1e3), r[CAT], r[TID]))
    return out


def idle_intervals(busy: Sequence[Tuple[int, int]], open_ns: int,
                   close_ns: int) -> List[Tuple[int, int]]:
    """The complement of merged, sorted ``busy`` intervals in the
    window."""
    out, edge = [], open_ns
    for a, b in list(busy) + [(close_ns, close_ns)]:
        a = min(a, close_ns)
        if a > edge:
            out.append((edge, a))
        edge = max(edge, b)
    return out


def _in_calls(idle, calls):
    """Pieces ``(a, b, kind)`` of the idle intervals inside the calls
    (``(kind, start_ns, end_ns)``, disjoint: one scheduler thread)."""
    calls = sorted(calls, key=lambda c: c[1])
    out, j = [], 0
    for a, b in idle:
        while j < len(calls) and calls[j][2] <= a:
            j += 1
        k = j
        while k < len(calls) and calls[k][1] < b:
            lo, hi = max(a, calls[k][1]), min(b, calls[k][2])
            if hi > lo:
                out.append((lo, hi, calls[k][0]))
            k += 1
    return out


def name_idle(idle: Sequence[Tuple[int, int]],
              calls: Sequence[Tuple[str, int, int]],
              spans: Iterable[Span], sched_tid: int
              ) -> List[Tuple[int, int, str, str]]:
    """Split the idle time inside the calls into pieces ``(a, b, kind,
    name)``, each named as the module says."""
    pieces = _in_calls(idle, calls)
    if not pieces:
        return []
    # boundaries: (t, 0 close | 1 open, span index); a close sorts first
    points = []
    spans = list(spans)
    for i, (a, b, cat, tid) in enumerate(spans):
        if cat == "gc" or tid == sched_tid:
            points.append((a, 1, i))
            points.append((b, 0, i))
    points.sort()
    out: List[Tuple[int, int, str, str]] = []
    stack: List[int] = []      # the scheduler's open spans, by start
    gc_open = 0
    p = 0

    def label() -> str:
        if gc_open:
            return "gc"
        if not stack:
            return "unnamed"
        return _BY_CAT.get(spans[stack[-1]][2], "unnamed")

    for a, b, kind in pieces:
        t = a
        while t < b:
            while p < len(points) and points[p][0] <= t:
                _, opening, i = points[p]
                if spans[i][2] == "gc":
                    gc_open += 1 if opening else -1
                elif opening:
                    stack.append(i)
                elif i in stack:
                    stack.remove(i)
                p += 1
            nxt = min(b, points[p][0]) if p < len(points) else b
            out.append((t, nxt, kind, label()))
            t = nxt
    return out


def idle_by_span(pieces) -> Dict[str, Dict[str, float]]:
    """Seconds of named idle time by call kind and name, every name
    present."""
    out: Dict[str, Dict[str, float]] = collections.defaultdict(
        lambda: dict.fromkeys(NAMES, 0.0))
    for a, b, kind, name in pieces:
        out[kind][name] += (b - a) / 1e9
    return {k: dict(v) for k, v in out.items()}


def share(pieces: Optional[list], name: str, window_s: float
          ) -> Optional[float]:
    """% of the window the card is idle while the host is in ``name``:
    ``0.0`` where the name holds no idle time, ``None`` where the run
    recorded no spans."""
    if pieces is None or not window_s:
        return None
    return 100.0 * sum(b - a for a, b, _, n in pieces
                       if n == name) / (window_s * 1e9)


def gap_names(gaps: Sequence[Tuple[int, int]], pieces) -> List[str]:
    """For each gap ``(a, b)``, the name that holds most of its named
    idle time (``""`` for a gap outside every call)."""
    out = []
    for a, b in gaps:
        held: Dict[str, int] = collections.defaultdict(int)
        for pa, pb, _, name in pieces:
            if pb > a and pa < b:
                held[name] += min(b, pb) - max(a, pa)
        out.append(max(held, key=held.get) if held else "")
    return out
