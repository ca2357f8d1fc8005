"""Observability for the relational inference engine.

Three layers, each usable on its own:

* :mod:`repro_torch.obs.metrics` — a dependency-free in-process metrics
  registry (counters / gauges / histograms) with Prometheus-style text
  exposition and a JSON dump.  The serving layer
  (``RelationalEngine`` / ``BatchedDecoder`` / ``ContinuousBatcher`` /
  ``WeightPager``) takes an optional registry and records TTFT,
  per-tick decode latency, batch occupancy, plan-cache and pager
  hit/miss, resident quantised bytes and preemptions.
* :mod:`repro_torch.obs.trace` — a span recorder with Chrome-trace
  (``chrome://tracing`` / Perfetto) JSON export.  ``run_pipeline``
  takes an optional recorder and emits one span per pipeline step;
  :mod:`repro_torch.obs.dbtrace` runs the *SQL* form of a pipeline under
  DuckDB ``EXPLAIN ANALYSE`` (JSON profiling) or SQLite timing and
  attributes per-operator wall time back to the pipeline steps and
  relational op classes that generated each statement
  (:mod:`repro_torch.obs.profile` is the engine-free profile parser).
* :mod:`repro_torch.obs.drift` — predicted-vs-observed cost drift per plan:
  per-step planner cost features paired with observed step timings,
  reported as a :class:`~repro_torch.obs.drift.DriftReport` and fed back
  into ``planner/calibrate.py`` as a calibration source
  (``fit_from_step_timings``).

Everything is zero-cost when disabled: call sites guard on
``tracer is None`` / ``metrics is None`` — no null-object dispatch on
the decode hot path.
"""

from repro_torch.obs.metrics import (OPENMETRICS_CONTENT_TYPE,  # noqa: F401
                                     PROMETHEUS_CONTENT_TYPE,
                                     Counter, Gauge, Histogram,
                                     MetricsRegistry)
from repro_torch.obs.context import (TraceContext, activate,  # noqa: F401
                                     context_span_args, current_context,
                                     new_trace_id)
from repro_torch.obs.trace import SpanEvent, TraceRecorder  # noqa: F401
from repro_torch.obs.flight import (FlightEvent,  # noqa: F401
                                    FlightRecorder, FlightTick)
from repro_torch.obs.log import (log_event,  # noqa: F401
                                 set_event_registry, set_flight_recorder)
from repro_torch.obs.profile import (AttributedOp, OpNode,  # noqa: F401
                                     attribute_query_plan,
                                     attribute_statement,
                                     classify_eqp_detail, classify_operator,
                                     coverage, flatten_profile,
                                     parse_profile, step_times_us)
from repro_torch.obs.drift import (DriftReport, StepDrift,  # noqa: F401
                                   drift_report)
from repro_torch.obs.dbtrace import (StatementTrace, TickTrace,  # noqa: F401
                                     run_statements, run_timed, run_traced,
                                     split_statements, substitute_params)
