"""Online drift watchdog: observe → diagnose → re-plan, mid-flight.

:class:`DriftWatchdog` closes the plan-feedback loop the offline
calibration path leaves open.  The flight recorder
(:mod:`repro_torch.obs.flight`) retains per-step span timings for every
decode tick the scheduler runs; every ``every`` ticks the watchdog
joins that observed window against the cost model's per-step
predictions (:func:`repro_torch.planner.calibrate.step_features`) via
:func:`repro_torch.obs.drift.drift_report`.  When the RMS relative drift
exceeds ``threshold`` it refits ``group_weight`` from the same window
(:func:`repro_torch.planner.calibrate.fit_from_step_timings`) and calls
:meth:`repro_torch.serving.engine.RelationalEngine.replan` — physical
planning re-runs under the recalibrated weights and the compiled plan
caches are swapped at a tick boundary.  Decode output stays
token-exact across the swap (see ``replan``'s pinning contract).

The watchdog is driven by :meth:`ContinuousBatcher.tick` at the END of
each tick, so a re-plan never lands under a pipeline in flight.  Every
step is wrapped defensively: a failing check logs a structured
``drift_watchdog_error`` event and never takes the serving loop down.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.obs.drift import drift_report
from repro_torch.obs.log import log_event
from repro_torch.planner.calibrate import fit_from_step_timings, step_features


class DriftWatchdog:
    """Periodic drift check over the flight recorder's decode window.

    Parameters
    ----------
    engine:
        The :class:`RelationalEngine` to re-plan (needs ``spec``, ``cs``,
        ``row2col``, ``max_len``, ``_cost_params`` and ``replan()``).
    flight:
        The :class:`repro_torch.obs.flight.FlightRecorder` the scheduler
        feeds; the watchdog reads windowed ``step_times_us`` from it.
    every:
        Check cadence in scheduler ticks.
    threshold:
        RMS relative drift (``drift_report.rms_rel_drift``) above which
        the watchdog refits and re-plans.  Drift ratios are computed
        with a self-fitted µs-per-unit scale, so the threshold measures
        *shape* mismatch between the cost model and reality — immune to
        the host simply being uniformly slower.
    batch:
        Batch size to price the decode features at (``0`` = the
        single-sequence graph).  Step names are shared across batch
        buckets, and both rows and groups scale with the bucket, so the
        drift *ratios* are insensitive to this choice; pass the
        server's max-batch bucket for predicted-µs readouts in the
        right ballpark.
    min_points:
        Minimum joined (feature, timing) steps for a window to count —
        below it the check is skipped entirely (mirrors
        ``fit_from_step_timings``'s determined-fit floor).
    metrics:
        Optional :class:`repro_torch.obs.metrics.MetricsRegistry`.
    """

    def __init__(self, engine, flight, every: int = 32,
                 threshold: float = 0.5, batch: int = 0,
                 min_points: int = 4, metrics=None):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.engine = engine
        self.flight = flight
        self.every = int(every)
        self.threshold = float(threshold)
        self.batch = int(batch)
        self.min_points = int(min_points)
        self.metrics = metrics
        self.ticks = 0
        self.checks = 0
        self.replans = 0
        self.errors = 0
        self.last_report = None          # DriftReport of the last check
        self.last_fit = None             # CalibrationFit of the last replan
        self._after_seq = -1             # flight seq watermark (window start)

    # -- scheduler hook ----------------------------------------------------

    def on_tick(self) -> bool:
        """Advance one scheduler tick; run a drift check every ``every``
        ticks.  Returns True when this tick triggered a re-plan."""
        self.ticks += 1
        if self.ticks % self.every:
            return False
        try:
            return self.check()
        except Exception as e:  # never take the serving loop down
            self.errors += 1
            log_event("drift_watchdog_error", error=repr(e),
                      tick=self.ticks)
            return False

    def check(self) -> bool:
        """Run one drift check over the decode ticks recorded since the
        last check; refit + re-plan past the threshold."""
        observed, last_seq = self.flight.step_times_us(
            kind="decode", cat="step", after_seq=self._after_seq)
        self._after_seq = last_seq  # window consumed, hit or miss
        if not observed:
            return False
        features = self._features()
        joined = len(set(features) & set(observed))
        if joined < self.min_points:
            return False
        self.checks += 1
        params = self.engine._cost_params
        rep = drift_report(
            features, observed,
            group_weight=getattr(params, "group_weight", 1.0)
            if params is not None else 1.0)
        self.last_report = rep
        if self.metrics is not None:
            self.metrics.gauge(
                "drift_watchdog_rms_rel_drift",
                "RMS relative drift at the last watchdog check").set(
                    rep.rms_rel_drift)
        log_event("drift_check", tick=self.ticks,
                  rms_rel_drift=rep.rms_rel_drift, n_steps=len(rep.steps),
                  unattributed_us=rep.unattributed_us)
        if rep.rms_rel_drift <= self.threshold:
            return False
        fit = fit_from_step_timings(features, observed, base=params)
        if fit.n_points < self.min_points:
            return False
        self.last_fit = fit
        log_event("drift_replan", tick=self.ticks,
                  rms_rel_drift=rep.rms_rel_drift,
                  group_weight=fit.params.group_weight,
                  scale_us=fit.scale_us, n_points=fit.n_points)
        self.engine.replan(fit.params)
        self.replans += 1
        if self.metrics is not None:
            self.metrics.counter(
                "drift_watchdog_replans_total",
                "re-plans triggered by the drift watchdog").inc()
        return True

    # -- internals ---------------------------------------------------------

    def _features(self) -> Dict:
        """Per-step (rows, groups) predictions for the decode pipeline
        under the engine's *current* cost weights — the join key for the
        observed window."""
        eng = self.engine
        return step_features(eng.spec, "decode", 1, eng.cs,
                             mode=eng.row2col, cache_len=eng.max_len,
                             params=eng._cost_params, batch=self.batch)

    # -- introspection (the /debug/drift endpoint) -------------------------

    def to_dict(self) -> Dict:
        fit = None
        if self.last_fit is not None:
            fit = {
                "group_weight": self.last_fit.params.group_weight,
                "scale_us": self.last_fit.scale_us,
                "intercept_us": self.last_fit.intercept_us,
                "residual_us": self.last_fit.residual_us,
                "n_points": self.last_fit.n_points,
            }
        return {
            "every": self.every,
            "threshold": self.threshold,
            "batch": self.batch,
            "ticks": self.ticks,
            "checks": self.checks,
            "replans": self.replans,
            "errors": self.errors,
            "engine_replans": getattr(self.engine, "replans", 0),
            "last_report": (self.last_report.to_dict()
                            if self.last_report is not None else None),
            "last_fit": fit,
        }
