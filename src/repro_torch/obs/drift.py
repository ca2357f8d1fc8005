"""Predicted-vs-observed cost drift per plan.

The planner prices every matmul site in abstract cost units
(``rows + group_weight · groups``, :mod:`repro_torch.planner.cost`); the
observability layer measures where the time actually went — per
pipeline step, either from a :class:`~repro_torch.obs.trace.TraceRecorder`
over ``run_pipeline`` (``step_times_us``) or from DuckDB per-operator
profiles (:func:`repro_torch.obs.profile.step_times_us`).  This module joins
the two: a least-squares scale maps cost units to microseconds and the
per-step drift ratio (observed / predicted) localises *where* the cost
model is wrong — the diagnosis the ROADMAP's plan-feedback item asks
for, with ``planner.calibrate.fit_from_step_timings`` as the
corrective feedback path.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class StepDrift:
    """One pipeline step's predicted-vs-observed record."""

    step: str
    rows: float
    groups: float
    predicted_units: float   # rows + group_weight · groups
    predicted_us: float      # scale_us · units + intercept_us
    observed_us: float
    ratio: float             # observed / predicted; 1.0 = on-model


@dataclasses.dataclass
class DriftReport:
    """Predicted-vs-observed cost drift over one pipeline run."""

    steps: List[StepDrift]
    scale_us: float          # fitted µs per cost unit
    intercept_us: float      # per-statement overhead the model can't see
    rms_rel_drift: float     # RMS of (ratio - 1) over modelled steps
    unattributed_us: float   # observed time on steps without cost features
    total_observed_us: float

    def worst(self, n: int = 3) -> List[StepDrift]:
        return sorted(self.steps, key=lambda s: abs(s.ratio - 1.0),
                      reverse=True)[:n]

    def to_dict(self) -> Dict:
        return {
            "scale_us_per_unit": self.scale_us,
            "intercept_us": self.intercept_us,
            "rms_rel_drift": self.rms_rel_drift,
            "unattributed_us": self.unattributed_us,
            "total_observed_us": self.total_observed_us,
            "steps": [dataclasses.asdict(s) for s in self.steps],
        }

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=str)


def _fit_scale(points: List[Tuple[float, float]]) -> Tuple[float, float]:
    """Least-squares ``observed ≈ scale · units + intercept`` (numpy-free;
    two unknowns).  One point pins the intercept at zero; degenerate
    spreads fall back to a pure scale through the mean."""
    n = len(points)
    if n == 0:
        return 0.0, 0.0
    sx = sum(u for u, _ in points)
    sy = sum(t for _, t in points)
    if n == 1:
        u, t = points[0]
        return (t / u if u else 0.0), 0.0
    sxx = sum(u * u for u, _ in points)
    sxy = sum(u * t for u, t in points)
    den = n * sxx - sx * sx
    if abs(den) < 1e-12:
        return (sy / sx if sx else 0.0), 0.0
    scale = (n * sxy - sx * sy) / den
    intercept = (sy - scale * sx) / n
    if scale <= 0:  # noise-dominated: keep a positive µs-per-unit scale
        return (sy / sx if sx else 0.0), 0.0
    return scale, intercept


def drift_report(features: Dict[str, Tuple[float, float]],
                 observed_us: Dict[str, float],
                 group_weight: float = 1.0,
                 scale_us: Optional[float] = None,
                 intercept_us: float = 0.0) -> DriftReport:
    """Join per-step cost features with observed step timings.

    ``features``: step → (rows, groups), e.g. from
    ``planner.calibrate.step_features``; ``observed_us``: step → µs, from
    ``TraceRecorder.step_times_us`` or ``obs.profile.step_times_us``.
    When ``scale_us`` is not given the µs-per-unit scale (and intercept)
    is fitted from this run's own points — drift ratios then measure the
    *shape* mismatch between model and measurement; pass a calibration
    fit's ``scale_us``/``intercept_us`` to measure absolute drift
    against a prior calibration instead.
    """
    modelled = {s: (r, g) for s, (r, g) in features.items()
                if s in observed_us}
    units = {s: r + group_weight * g for s, (r, g) in modelled.items()}
    if scale_us is None:
        scale_us, intercept_us = _fit_scale(
            [(units[s], observed_us[s]) for s in sorted(modelled)])
    steps = []
    for s in sorted(modelled):
        r, g = modelled[s]
        pred = scale_us * units[s] + intercept_us
        obs = observed_us[s]
        steps.append(StepDrift(
            step=s, rows=r, groups=g, predicted_units=units[s],
            predicted_us=pred, observed_us=obs,
            ratio=(obs / pred) if pred > 0 else float("inf")))
    finite = [st.ratio - 1.0 for st in steps if math.isfinite(st.ratio)]
    rms = math.sqrt(sum(d * d for d in finite) / len(finite)) if finite \
        else 0.0
    total = sum(observed_us.values())
    unattributed = sum(t for s, t in observed_us.items()
                       if s not in modelled)
    return DriftReport(steps=steps, scale_us=scale_us,
                       intercept_us=intercept_us, rms_rel_drift=rms,
                       unattributed_us=unattributed,
                       total_observed_us=total)
