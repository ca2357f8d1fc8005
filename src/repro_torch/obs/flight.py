"""Flight recorder: a bounded ring buffer of recent scheduler ticks.

A long-running server cannot keep every span forever, but "the trace
evaporated before anyone looked at it" is exactly the failure mode that
makes tail latencies undebuggable.  The :class:`FlightRecorder` keeps
the *last N* ticks' spans — admission records, per-request prefills,
batched decode ticks — plus interleaved ``log_event`` records, indexed
per request, and lets SLO-violating requests **pin** their ticks as
exemplars so the interesting traces outlive the ring.

The scheduler thread is the only writer of tick records; HTTP handler
threads read concurrently through the ``/debug/*`` endpoints, and
``log_event`` may fire from any thread — everything mutating or
snapshotting shared state runs under one lock (operations are O(ring),
never O(history), so the lock stays cheap).

Timeline: span timestamps are microseconds since the *tracer's* epoch.
Construct the recorder with ``epoch_s=tracer._epoch`` (or via
:meth:`FlightRecorder.for_tracer`) and event/tick timestamps land on
the same timeline (the tracer's clock), so a dump interleaves spans,
events and tick boundaries in true order.

Retention: a tick keeps its spans as the tracer's records (tuples of
atomic values, :mod:`repro_torch.obs.trace`), which the cyclic collector
does not walk; :attr:`FlightTick.spans` reads them as
:class:`~repro_torch.obs.trace.SpanEvent`\\ s.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from .trace import CAT, DEPTH, DUR, NAME, TS, SpanEvent, record_us

__all__ = ["FlightRecorder", "FlightTick", "FlightEvent"]


@dataclasses.dataclass
class FlightTick:
    """One scheduler-tick record: the spans it emitted plus the request
    ids it served.  ``kind`` is ``admission`` / ``prefill`` /
    ``decode``."""

    seq: int                      # recorder-wide monotonic sequence no.
    tick: int                     # scheduler tick counter at record time
    kind: str
    ts_us: float                  # start, µs on the shared epoch
    wall_us: float                # wall time of the underlying work
    request_ids: Tuple[int, ...] = ()
    trace_ids: Tuple[str, ...] = ()
    records: Tuple[tuple, ...] = ()  # the tick's spans, as trace records
    pinned: bool = False

    @property
    def spans(self) -> Tuple[SpanEvent, ...]:
        return tuple(SpanEvent.from_record(r) for r in self.records)

    def named_us(self) -> float:
        """Wall time attributed to named top-level spans.  Only
        depth-0 spans count — nested op/DB sub-spans re-describe time
        their parent already covers."""
        return sum(r[DUR] for r in self.records if r[DEPTH] == 0)

    def coverage(self) -> float:
        """Fraction of this tick's wall time attributed to named spans
        (clipped to 1.0 — span clocks can overshoot the outer wall
        measurement by scheduling noise)."""
        if self.wall_us <= 0:
            return 1.0 if not self.records else 0.0
        return min(1.0, self.named_us() / self.wall_us)

    def step_times_us(self, cat: str = "step") -> Dict[str, float]:
        """Summed time per span name within ``cat``: a step's
        ``device_us`` where the card's events gave one, else its
        duration."""
        out: Dict[str, float] = {}
        for r in self.records:
            if r[CAT] == cat:
                out[r[NAME]] = out.get(r[NAME], 0.0) + record_us(r)
        return out

    def to_dict(self, with_spans: bool = False) -> Dict:
        d = {"seq": self.seq, "tick": self.tick, "kind": self.kind,
             "ts_us": self.ts_us, "wall_us": self.wall_us,
             "request_ids": list(self.request_ids),
             "trace_ids": list(self.trace_ids),
             "n_spans": len(self.records), "coverage": self.coverage(),
             "pinned": self.pinned}
        if with_spans:
            d["spans"] = [dataclasses.asdict(s) for s in self.spans]
        return d


@dataclasses.dataclass
class FlightEvent:
    """One ``log_event`` record on the shared timeline."""

    ts_us: float
    event: str
    fields: Dict

    def to_dict(self) -> Dict:
        return {"ts_us": self.ts_us, "event": self.event,
                "fields": dict(self.fields)}


class FlightRecorder:
    def __init__(self, capacity: int = 256, event_capacity: int = 1024,
                 max_pinned: int = 16, epoch_s: Optional[float] = None,
                 clock=time.perf_counter):
        self.capacity = int(capacity)
        self.max_pinned = int(max_pinned)
        self._clock = clock
        self._epoch = clock() if epoch_s is None else epoch_s
        self._lock = threading.Lock()
        self._ticks: Deque[FlightTick] = deque()
        self._events: Deque[FlightEvent] = deque(maxlen=int(event_capacity))
        # request index: both the hex trace_id and the stringified rid
        # key the same tick list, so /debug/trace/{id} accepts either.
        self._by_request: Dict[str, List[FlightTick]] = {}
        # pinned exemplars: trace_id -> ticks kept past ring eviction
        self._pinned: Dict[str, List[FlightTick]] = {}
        self._pin_order: Deque[str] = deque()
        self._seq = 0
        self.dropped_ticks = 0

    @classmethod
    def for_tracer(cls, tracer, **kw) -> "FlightRecorder":
        return cls(epoch_s=tracer._epoch, clock=tracer._clock, **kw)

    def now_us(self) -> float:
        return (self._clock() - self._epoch) * 1e6

    @property
    def next_seq(self) -> int:
        """The sequence number the next tick will get: a reader that
        takes it at some instant and later finds the oldest retained tick
        past it knows the ring dropped ticks in between."""
        with self._lock:
            return self._seq

    # -- writes (scheduler thread / any thread for events) ---------------------

    def record_tick(self, kind: str, spans: Sequence = (),
                    wall_us: float = 0.0, tick: int = 0,
                    request_ids: Sequence[int] = (),
                    trace_ids: Sequence[str] = (),
                    ts_us: Optional[float] = None) -> FlightTick:
        """Record one tick; ``spans`` are the tracer's records (as
        :meth:`~repro_torch.obs.trace.TraceRecorder.drain_records` gives
        them) or :class:`SpanEvent`\\ s."""
        records = tuple(s if type(s) is tuple else s.to_record()
                        for s in spans)
        if ts_us is None:
            ts_us = (records[0][TS] if records
                     else self.now_us() - wall_us)
        rec = FlightTick(seq=0, tick=tick, kind=kind, ts_us=float(ts_us),
                         wall_us=float(wall_us),
                         request_ids=tuple(request_ids),
                         trace_ids=tuple(trace_ids), records=records)
        with self._lock:
            rec.seq = self._seq
            self._seq += 1
            self._ticks.append(rec)
            for key in self._index_keys(rec):
                self._by_request.setdefault(key, []).append(rec)
            if rec.trace_ids and any(t in self._pinned
                                     for t in rec.trace_ids):
                self._pin_tick(rec)
            while len(self._ticks) > self.capacity:
                self._evict(self._ticks.popleft())
        return rec

    def record_admission(self, rid: int, trace_id: str, wall_us: float = 0.0,
                         tick: int = 0, **args) -> FlightTick:
        """A synthetic one-span tick marking HTTP admission, so a
        request's reconstructed trace starts at its true beginning."""
        ts = self.now_us() - wall_us
        span = SpanEvent(name="admission", cat="admission", ts_us=ts,
                         dur_us=wall_us, depth=0,
                         args={"rids": [rid], "trace_ids": [trace_id],
                               **args})
        return self.record_tick("admission", spans=(span,), wall_us=wall_us,
                                tick=tick, request_ids=(rid,),
                                trace_ids=(trace_id,), ts_us=ts)

    def record_event(self, event: str, fields: Optional[Dict] = None,
                     ts_us: Optional[float] = None) -> FlightEvent:
        rec = FlightEvent(ts_us=self.now_us() if ts_us is None else ts_us,
                          event=event, fields=dict(fields or {}))
        with self._lock:
            self._events.append(rec)
        return rec

    def pin(self, trace_id: str, reason: str = "") -> None:
        """Keep every retained tick that served ``trace_id`` (and all
        future ones) past ring eviction — SLO violators call this so
        the interesting traces survive as exemplars.  Oldest pins fall
        off past ``max_pinned``."""
        with self._lock:
            if trace_id in self._pinned:
                return
            while len(self._pin_order) >= self.max_pinned:
                old = self._pin_order.popleft()
                for t in self._pinned.pop(old, ()):
                    t.pinned = any(tid in self._pinned
                                   for tid in t.trace_ids)
            self._pin_order.append(trace_id)
            self._pinned[trace_id] = [
                t for t in self._by_request.get(trace_id, ())]
            for t in self._pinned[trace_id]:
                t.pinned = True

    # -- internals (call under self._lock) -------------------------------------

    @staticmethod
    def _index_keys(rec: FlightTick):
        for tid in rec.trace_ids:
            yield tid
        for rid in rec.request_ids:
            yield str(rid)

    def _pin_tick(self, rec: FlightTick) -> None:
        rec.pinned = True
        for tid in rec.trace_ids:
            if tid in self._pinned:
                self._pinned[tid].append(rec)

    def _evict(self, rec: FlightTick) -> None:
        self.dropped_ticks += 1
        if rec.pinned:
            return  # stays reachable via the index / pinned store
        for key in self._index_keys(rec):
            lst = self._by_request.get(key)
            if lst is not None:
                try:
                    lst.remove(rec)
                except ValueError:
                    pass
                if not lst:
                    del self._by_request[key]

    # -- reads (HTTP threads) ---------------------------------------------------

    def ticks(self) -> List[FlightTick]:
        with self._lock:
            return list(self._ticks)

    def events(self) -> List[FlightEvent]:
        with self._lock:
            return list(self._events)

    def step_times_us(self, kind: str = "decode", cat: str = "step",
                      after_seq: int = -1) -> Tuple[Dict[str, float], int]:
        """Aggregate per-step span durations over retained ticks of
        ``kind`` with ``seq > after_seq`` — the watchdog's windowed
        observation.  Returns ``(step -> µs, last seq seen)``."""
        out: Dict[str, float] = {}
        last = after_seq
        with self._lock:
            snapshot = list(self._ticks)
        for t in snapshot:
            if t.kind != kind or t.seq <= after_seq:
                continue
            last = max(last, t.seq)
            for name, us in t.step_times_us(cat).items():
                out[name] = out.get(name, 0.0) + us
        return out, last

    def request_ticks(self, request_id: str) -> List[FlightTick]:
        """Every retained or pinned tick that served ``request_id``
        (a hex trace_id or a stringified rid), in record order."""
        with self._lock:
            return list(self._by_request.get(str(request_id), ()))

    def request_trace(self, request_id: str) -> Optional[Dict]:
        """Reconstruct one request end-to-end as Chrome-trace JSON:
        admission → prefill → each decode tick it rode, with the
        request's own spans on pid 1 and per-tick boundary markers.
        Extra top-level keys (``coverage`` et al.) are ignored by trace
        viewers but consumed by CI's attribution assertion.  ``None``
        when the id is unknown (evicted or never seen)."""
        ticks = self.request_ticks(request_id)
        if not ticks:
            return None
        key = str(request_id)
        events, wall, named = [], 0.0, 0.0
        for t in ticks:
            events.append({"name": f"{t.kind} tick {t.tick}", "cat": "tick",
                           "ph": "X", "ts": t.ts_us, "dur": t.wall_us,
                           "pid": 1, "tid": 0,
                           "args": {"kind": t.kind, "seq": t.seq,
                                    "coverage": t.coverage()}})
            wall += t.wall_us
            named += min(t.wall_us, t.named_us())
            for s in t.spans:
                if not self._span_serves(s, t, key):
                    continue
                events.append({"name": s.name, "cat": s.cat or "default",
                               "ph": "X", "ts": s.ts_us, "dur": s.dur_us,
                               "pid": 1, "tid": s.depth + 1,
                               "args": s.args})
        # resolve the (rid, trace_id) pair through the parallel tuples
        rid_of: Dict[str, int] = {}
        for t in ticks:
            for r, x in zip(t.request_ids, t.trace_ids):
                rid_of[x] = r
                rid_of[str(r)] = r
        rid = rid_of.get(key)
        trace_id = key if key in rid_of and not key.isdigit() else next(
            (x for t in ticks for r, x in zip(t.request_ids, t.trace_ids)
             if str(r) == key), key)
        return {
            "displayTimeUnit": "ms",
            "request_id": rid if rid is not None else key,
            "trace_id": trace_id,
            "ticks": [t.to_dict() for t in ticks],
            "wall_us": wall,
            "named_us": named,
            "coverage": (named / wall) if wall > 0 else 1.0,
            "traceEvents": sorted(events, key=lambda e: e["ts"]),
        }

    @staticmethod
    def _span_serves(span: SpanEvent, tick: FlightTick, key: str) -> bool:
        """Does ``span`` belong to request ``key``?  Context-attached
        args are authoritative; spans with no request attribution
        (e.g. pager prefetches) count for every request on the tick."""
        tids = span.args.get("trace_ids")
        rids = span.args.get("rids")
        if tids is None and rids is None:
            return True
        if tids and key in tids:
            return True
        if rids and any(str(r) == key for r in rids):
            return True
        return False

    def to_chrome(self, pid: int = 1) -> Dict:
        """Every retained tick's spans plus interleaved instant events,
        one shared timeline — the shutdown-artifact dump."""
        with self._lock:
            ticks = list(self._ticks)
            events = list(self._events)
        out = []
        for t in ticks:
            out.append({"name": f"{t.kind} tick {t.tick}", "cat": "tick",
                        "ph": "X", "ts": t.ts_us, "dur": t.wall_us,
                        "pid": pid, "tid": 0,
                        "args": {"rids": list(t.request_ids),
                                 "trace_ids": list(t.trace_ids)}})
            for s in t.spans:
                out.append({"name": s.name, "cat": s.cat or "default",
                            "ph": "X", "ts": s.ts_us, "dur": s.dur_us,
                            "pid": pid, "tid": s.depth + 1, "args": s.args})
        for e in events:
            out.append({"name": e.event, "cat": "event", "ph": "i",
                        "ts": e.ts_us, "pid": pid, "tid": 0, "s": "g",
                        "args": dict(e.fields)})
        return {"displayTimeUnit": "ms",
                "traceEvents": sorted(out, key=lambda e: e["ts"])}

    def to_dict(self) -> Dict:
        with self._lock:
            ticks = list(self._ticks)
            events = list(self._events)
            pinned = {k: [t.seq for t in v] for k, v in self._pinned.items()}
            n_indexed = len(self._by_request)
        return {
            "capacity": self.capacity,
            "retained_ticks": len(ticks),
            "dropped_ticks": self.dropped_ticks,
            "indexed_requests": n_indexed,
            "pinned": pinned,
            "ticks": [t.to_dict() for t in ticks],
            "events": [e.to_dict() for e in events],
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=2, default=str)
