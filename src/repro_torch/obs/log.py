"""Structured event logging for planner/serving diagnostics.

``log_event("calibration_fallback", weight="dequant_weight", ...)``
emits one structured record through the stdlib ``repro_torch.obs`` logger —
a human-readable ``event key=value`` line whose fields also ride on the
record (``record.obs_fields``) for structured handlers — and, when an
event registry is installed, bumps an ``obs_events_total`` counter
labelled by event name so silent degradations (e.g. a calibration fit
falling back to analytic defaults) are visible in the metrics dump,
not just in a log nobody tails.

Every record carries a monotonic timestamp (``ts_s``,
``time.perf_counter`` seconds) and auto-attaches the active
:class:`~repro_torch.obs.context.TraceContext` (if any), so events name the
request(s) in flight when they fired.  When a flight recorder is
installed (:func:`set_flight_recorder`) each event is also forwarded to
its ring, where dumps interleave events with spans in timeline order.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

from repro_torch.obs.context import context_span_args
from repro_torch.obs.metrics import MetricsRegistry

logger = logging.getLogger("repro_torch.obs")

_event_registry: Optional[MetricsRegistry] = None
_flight_recorder = None


def set_event_registry(registry: Optional[MetricsRegistry]) -> None:
    """Install (or clear, with None) the registry that counts events."""
    global _event_registry
    _event_registry = registry


def set_flight_recorder(flight) -> None:
    """Install (or clear, with None) the flight recorder that retains
    events for ``/debug/flight`` dumps."""
    global _flight_recorder
    _flight_recorder = flight


def log_event(event: str, level: int = logging.WARNING, **fields) -> None:
    ts_s = time.perf_counter()  # monotonic — interleaves with span ts
    ctx_fields = context_span_args()
    if ctx_fields:
        ctx_fields.update(fields)
        fields = ctx_fields
    kv = " ".join(f"{k}={v}" for k, v in sorted(fields.items()))
    logger.log(level, "%s %s", event, kv,
               extra={"obs_fields": {"event": event, "ts_s": ts_s,
                                     **fields}})
    if _event_registry is not None:
        _event_registry.counter(
            "obs_events_total", "structured obs events by name",
            event=event).inc()
    flight = _flight_recorder
    if flight is not None:
        # on the flight recorder's clock, which is its tracer's
        flight.record_event(event, fields)
