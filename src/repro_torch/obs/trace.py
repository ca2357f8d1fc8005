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

Clock: spans are stamped in microseconds since the recorder's epoch on
``time.time`` (the host's realtime clock), the clock ``torch.profiler``
puts the card's kernels and copies on, so ``epoch_ns + ts_us * 1000``
places a span beside them.  A test may pass another ``clock`` (seconds).

Retention: a span is kept as a *record*, one flat tuple of atomic values
``(name, cat, ts_us, dur_us, depth, tid, key, value, key, value, ...)``:
``tid`` is the recording thread's ``threading.get_ident()``, and a list
among the args becomes a tuple (the step and op spans' provenance comes
as tuples, and a tick's request ids are frozen once a context, so most
spans copy nothing).  CPython's cyclic collector untracks a tuple of
untracked items when it passes over it, in the young collections soon
after the span is made, so a flight ring holding thousands of ticks'
spans adds nothing to a full collection.  :class:`SpanEvent` is the
readable view of a record.

Device time: a ``cat="step"`` span does not wait for the card; it is the
host's dispatch of the step.  :meth:`TraceRecorder.device_span` records
a pair of CUDA events (from a pool) on the stream at the span's edges,
and :meth:`TraceRecorder.resolve_device` — called by the engine after
the host read each call already makes — stores the time between them
in the span's args as ``device_us``.

Tracing is zero-cost when disabled by convention: instrumented call
sites take ``tracer: Optional[TraceRecorder]`` and guard with
``if tracer is not None`` — there is no null recorder on the hot path.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import threading
import time
from typing import Dict, List, Optional

from .context import current_context

# the fields of a span record; its args follow from ARGS on, as
# alternating keys and values
NAME, CAT, TS, DUR, DEPTH, TID, ARGS = range(7)


def freeze_args(args: Dict) -> tuple:
    """``args`` as alternating keys and atomic values: a list becomes a
    tuple (its items frozen the same way)."""
    out = []
    for k, v in args.items():
        out += (k, _freeze(v))
    return tuple(out)


def _freeze(v):
    """A list as a tuple (its items frozen the same way); a tuple is
    taken as frozen already."""
    if isinstance(v, list):
        return tuple(_freeze(x) for x in v)
    return v


def _thaw(v):
    if isinstance(v, tuple):
        return [_thaw(x) for x in v]
    return v


def record_arg(rec: tuple, key: str, default=None):
    """One arg of a record, as it was frozen."""
    for i in range(ARGS, len(rec), 2):
        if rec[i] == key:
            return rec[i + 1]
    return default


def record_us(rec: tuple) -> float:
    """A step span's time: its ``device_us`` where the card's events
    gave one, else its duration on the host."""
    return record_arg(rec, "device_us", rec[DUR])


@dataclasses.dataclass
class SpanEvent:
    """One complete span (Chrome ``ph: "X"`` event): the readable view
    of a record."""

    name: str
    cat: str
    ts_us: float          # start, microseconds since the recorder's epoch
    dur_us: float
    depth: int = 0        # nesting depth at open time (Chrome tid)
    args: Dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_record(cls, rec: tuple) -> "SpanEvent":
        return cls(name=rec[NAME], cat=rec[CAT], ts_us=rec[TS],
                   dur_us=rec[DUR], depth=rec[DEPTH],
                   args={rec[i]: _thaw(rec[i + 1])
                         for i in range(ARGS, len(rec), 2)})

    def to_record(self) -> tuple:
        """The span as a record (of no thread: ``tid`` 0)."""
        return (self.name, self.cat, float(self.ts_us), float(self.dur_us),
                self.depth, 0) + freeze_args(self.args)


class _Span:
    """The context manager :meth:`TraceRecorder.span` and
    :meth:`TraceRecorder.device_span` return."""

    __slots__ = ("tracer", "name", "cat", "args", "stream", "depth", "t0",
                 "events")

    def __init__(self, tracer, name, cat, args, stream):
        self.tracer, self.name, self.cat = tracer, name, cat
        self.args, self.stream = args, stream

    def __enter__(self):
        tracer = self.tracer
        self.depth = tracer._depth
        tracer._depth += 1
        if self.stream is not None:
            self.events = (tracer._event(), tracer._event())
            self.events[0].record(self.stream)
        self.t0 = tracer._now_us()
        return tracer

    def __exit__(self, *exc):
        tracer = self.tracer
        if self.stream is not None:
            self.events[1].record(self.stream)
        tracer._depth = self.depth
        rec = tracer._record(self.name, self.cat, self.t0, None,
                             self.depth, self.args)
        if self.stream is not None:
            tracer._pending.append((rec, *self.events, self.stream))
        return False


class TraceRecorder:
    def __init__(self, clock=time.time):
        self._clock = clock
        self._epoch = clock()
        self._depth = 0
        self._records: List[tuple] = []
        # step spans whose CUDA events are not yet read: (record, start,
        # end, stream), and the pool the events come from
        self._pending: List[tuple] = []
        self._pool: list = []

    @property
    def epoch_ns(self) -> int:
        """The epoch in ns of the recorder's clock: a span starts at
        ``epoch_ns + ts_us * 1000``."""
        return round(self._epoch * 1e9)

    def _now_us(self) -> float:
        return (self._clock() - self._epoch) * 1e6

    @property
    def events(self) -> List[SpanEvent]:
        """The recorded spans, in the order they closed."""
        return [SpanEvent.from_record(r) for r in self._records]

    def _record(self, name: str, cat: str, t0: float, dur_us, depth: int,
                args: Dict) -> tuple:
        """Append a record; ``dur_us=None`` closes the span now (its own
        bookkeeping inside it).  The ambient :class:`repro_torch.obs.
        context.TraceContext` (if any) is folded into its args, explicit
        args winning on a key collision."""
        ctx = current_context()
        head = ()
        if ctx is not None:
            if args and not ctx.record_keys.isdisjoint(args):
                args = {**ctx.span_args(), **args}
            else:
                head = ctx.record_args
        if args:
            head += freeze_args(args)
        if dur_us is None:
            dur_us = self._now_us() - t0
        rec = (name, cat, t0, dur_us, depth, threading.get_ident()) + head
        self._records.append(rec)
        return rec

    def span(self, name: str, cat: str = "", **args) -> _Span:
        """Record a complete span around the ``with`` body."""
        return _Span(self, name, cat, args, None)

    def device_span(self, name: str, cat: str, stream, **args) -> _Span:
        """:meth:`span`, and with a CUDA ``stream`` a pair of timing
        events recorded on it at the span's edges, read into the span's
        ``device_us`` by :meth:`resolve_device`.  Nothing waits for the
        card here."""
        return _Span(self, name, cat, args, stream)

    def _event(self):
        if self._pool:
            return self._pool.pop()
        import torch
        return torch.cuda.Event(enable_timing=True)

    def resolve_device(self) -> None:
        """Read the events of every pending :meth:`device_span` into its
        record's args as ``device_us``.  Call once the host has read a
        result the spans' work produced (the call's logits), so the
        events have completed and reading them waits for nothing."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        # a stream's events complete in order: wait for its last one
        last = {id(stream): end for _, _, end, stream in pending}
        for end in last.values():
            end.synchronize()
        done = {}
        for rec, start, end, _ in pending:
            done[id(rec)] = (rec, start.elapsed_time(end) * 1e3)
            self._pool += (start, end)
        recs, left = self._records, len(done)
        for i in range(len(recs) - 1, -1, -1):
            hit = done.get(id(recs[i]))
            if hit is None or hit[0] is not recs[i]:
                continue
            rec, us = hit
            recs[i] = rec + ("device_us", us)
            left -= 1
            if not left:
                break

    def _drop_pending(self) -> None:
        """Forget unread events (their spans left the recorder)."""
        for _, start, end, _ in self._pending:
            self._pool += (start, end)
        self._pending.clear()

    def add_span(self, name: str, cat: str, ts_us: float, dur_us: float,
                 depth: int = 0, **args) -> SpanEvent:
        """Append a span with explicit timing (DB profile ingestion, the
        pager, plan compiles, collections).

        Unlike :meth:`span` this never touches ``_depth``, so it is safe
        to call from threads other than the one driving ``span()`` (the
        pager's prefetch thread does).  The ambient trace context is
        attached the same way.
        """
        return SpanEvent.from_record(self._record(
            name, cat, float(ts_us), float(dur_us), depth, args))

    def clear(self) -> None:
        self._records.clear()
        self._drop_pending()
        self._epoch = self._clock()
        self._depth = 0

    def drain_records(self, start: int = 0) -> List[tuple]:
        """Remove and return ``records[start:]`` *without* resetting the
        epoch (unlike :meth:`clear`) — the flight recorder drains the
        tracer after every scheduler tick so a long-running server never
        accumulates an unbounded span list, while keeping all drained
        spans on one shared timeline."""
        out = self._records[start:]
        # delete exactly the captured slice — a concurrent add_span (the
        # pager's prefetch thread, a collection) landing after the copy
        # shifts down instead of being silently dropped
        del self._records[start:start + len(out)]
        if self._pending:
            self._drop_pending()
        return out

    def drain(self, start: int = 0) -> List[SpanEvent]:
        """:meth:`drain_records`, as :class:`SpanEvent`\\ s."""
        return [SpanEvent.from_record(r) for r in self.drain_records(start)]

    # -- queries ---------------------------------------------------------------

    def total_us(self, cat: Optional[str] = None) -> float:
        return sum(r[DUR] for r in self._records
                   if cat is None or r[CAT] == cat)

    def step_times_us(self, cat: str = "step") -> Dict[str, float]:
        """Summed time per span name within a category (``device_us``
        where the card's events gave it) — the observed per-step timings
        the drift report consumes."""
        out: Dict[str, float] = {}
        for r in self._records:
            if r[CAT] == cat:
                out[r[NAME]] = out.get(r[NAME], 0.0) + record_us(r)
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


class GcSpans:
    """A ``gc.callbacks`` hook that records one ``cat="gc"`` span named
    ``gc`` a collection into ``tracer`` (its ``generation`` and
    ``collected`` in the args), at the tracer's open-span depth: the
    thread that set the collection off may be any, and every thread
    stops while it runs."""

    def __init__(self, tracer: TraceRecorder):
        self.tracer = tracer
        self._t0: Optional[float] = None

    def __call__(self, phase: str, info: Dict) -> None:
        tracer = self.tracer
        if phase == "start":
            self._t0 = tracer._now_us()
        elif self._t0 is not None:
            t0, self._t0 = self._t0, None
            tracer.add_span("gc", "gc", t0, tracer._now_us() - t0,
                            depth=tracer._depth,
                            generation=info["generation"],
                            collected=info["collected"])

    def install(self) -> "GcSpans":
        gc.callbacks.append(self)
        return self

    def remove(self) -> None:
        if self in gc.callbacks:
            gc.callbacks.remove(self)
