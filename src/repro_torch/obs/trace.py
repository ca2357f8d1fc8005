"""Span tracing with Chrome-trace export.

:class:`TraceRecorder` collects complete (``ph: "X"``) spans — one per
pipeline step when passed to ``run_pipeline``, one per SQL statement
when driven by :mod:`repro_torch.obs.dbtrace` — and exports them in the
Chrome trace event format, loadable in ``chrome://tracing`` or
https://ui.perfetto.dev.

Spans nest: ``span()`` is a context manager and the recorder tracks
the open-span depth, mapping it to the Chrome ``tid`` so nested spans
render stacked.  DB-operator sub-spans added after the fact
(:func:`repro_torch.obs.dbtrace`) ride in via :meth:`TraceRecorder.add_span`
with explicit timestamps.

Tracing is zero-cost when disabled by convention: instrumented call
sites take ``tracer: Optional[TraceRecorder]`` and guard with
``if tracer is not None`` — there is no null recorder on the hot path.
"""

from __future__ import annotations

import dataclasses
import json
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

from .context import context_span_args


@dataclasses.dataclass
class SpanEvent:
    """One complete span (Chrome ``ph: "X"`` event)."""

    name: str
    cat: str
    ts_us: float          # start, microseconds since the recorder's epoch
    dur_us: float
    depth: int = 0        # nesting depth at open time (Chrome tid)
    args: Dict = dataclasses.field(default_factory=dict)


class TraceRecorder:
    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._epoch = clock()
        self._depth = 0
        self.events: List[SpanEvent] = []

    def _now_us(self) -> float:
        return (self._clock() - self._epoch) * 1e6

    @contextmanager
    def span(self, name: str, cat: str = "", **args):
        """Record a complete span around the ``with`` body.

        The ambient :class:`repro_torch.obs.context.TraceContext` (if any) is
        folded into the span's args at record time, so every span
        automatically names the request ids / trace ids it served —
        explicit kwargs win on key collision.
        """
        depth = self._depth
        self._depth += 1
        t0 = self._now_us()
        try:
            yield self
        finally:
            self._depth = depth
            ctx_args = context_span_args()
            if ctx_args:
                ctx_args.update(args)
                args = ctx_args
            self.events.append(SpanEvent(name=name, cat=cat, ts_us=t0,
                                         dur_us=self._now_us() - t0,
                                         depth=depth, args=dict(args)))

    def add_span(self, name: str, cat: str, ts_us: float, dur_us: float,
                 depth: int = 0, **args) -> SpanEvent:
        """Append a span with explicit timing (DB profile ingestion).

        Unlike :meth:`span` this never touches ``_depth``, so it is safe
        to call from threads other than the one driving ``span()`` (the
        pager's prefetch thread does).  The ambient trace context is
        attached the same way.
        """
        ctx_args = context_span_args()
        if ctx_args:
            ctx_args.update(args)
            args = ctx_args
        ev = SpanEvent(name=name, cat=cat, ts_us=float(ts_us),
                       dur_us=float(dur_us), depth=depth, args=dict(args))
        self.events.append(ev)
        return ev

    def clear(self) -> None:
        self.events.clear()
        self._epoch = self._clock()
        self._depth = 0

    def drain(self, start: int = 0) -> List[SpanEvent]:
        """Remove and return ``events[start:]`` *without* resetting the
        epoch (unlike :meth:`clear`) — the flight recorder drains the
        tracer after every scheduler tick so a long-running server never
        accumulates an unbounded span list, while keeping all drained
        spans on one shared timeline."""
        out = self.events[start:]
        # delete exactly the captured slice — a concurrent add_span (the
        # pager's prefetch thread) landing after the copy shifts down
        # instead of being silently dropped
        del self.events[start:start + len(out)]
        return out

    # -- queries ---------------------------------------------------------------

    def total_us(self, cat: Optional[str] = None) -> float:
        return sum(e.dur_us for e in self.events
                   if cat is None or e.cat == cat)

    def step_times_us(self, cat: str = "step") -> Dict[str, float]:
        """Summed duration per span name within a category — the observed
        per-step timings the drift report consumes."""
        out: Dict[str, float] = {}
        for e in self.events:
            if e.cat == cat:
                out[e.name] = out.get(e.name, 0.0) + e.dur_us
        return out

    # -- export ----------------------------------------------------------------

    def to_chrome(self, pid: int = 1) -> Dict:
        """Chrome trace event format (catapult JSON object form)."""
        return {
            "displayTimeUnit": "ms",
            "traceEvents": [
                {"name": e.name, "cat": e.cat or "default", "ph": "X",
                 "ts": e.ts_us, "dur": e.dur_us, "pid": pid,
                 "tid": e.depth, "args": e.args}
                for e in sorted(self.events, key=lambda e: e.ts_us)
            ],
        }

    def save(self, path: str, pid: int = 1) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(pid=pid), f, indent=2, default=str)
