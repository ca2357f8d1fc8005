"""Accuracy-budget gate: quantised logits must stay within a configurable
tolerance of the f32 engine's.

Quantisation is only admissible while it cannot change what the model
*says*: the gate runs the same prompt through a quantised and an f32
``RelationalEngine`` and compares the final-position logits.  The default
budgets derive from the codec error bounds scaled by an empirical depth
factor; pass an explicit ``tolerance`` to tighten or relax them
(``RelationalEngine(precision=..., accuracy_budget=...)`` runs the gate at
construction time on a small probe prompt).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

#: Default max-|Δlogit| budgets per codec.  These are deliberately loose
#: "sanity budgets" (quantisation error compounds through layers and
#: depends on the model's logit dynamic range); production deployments
#: should calibrate them per model and pass an explicit tolerance.
DEFAULT_TOLERANCES: Dict[str, float] = {"f32": 0.0, "int8": 0.5, "nf4": 2.0}

_PROBE_PROMPT = (3, 1, 2)


class AccuracyBudgetExceeded(RuntimeError):
    """Raised when a quantised engine's logit error exceeds its budget."""


def max_logit_error(spec, params, precision: str,
                    prompt: Optional[Sequence[int]] = None,
                    table_precisions: Optional[Dict[str, str]] = None,
                    **engine_kwargs) -> float:
    """Max |logit − f32 logit| at the final prompt position.

    Builds two in-memory engines (quantised and f32 reference) with
    otherwise identical knobs and compares their prefill logits.
    """
    from repro_torch.serving.engine import RelationalEngine
    prompt = list(prompt if prompt is not None else _PROBE_PROMPT)
    prompt = [int(t) % spec.vocab for t in prompt]
    engine_kwargs.setdefault("residency", "in_memory")
    ref = RelationalEngine(spec, params, precision="f32", **engine_kwargs)
    got = RelationalEngine(spec, params, precision=precision,
                           table_precisions=table_precisions,
                           **engine_kwargs)
    return logit_error_between(got, ref, prompt)


def logit_error_between(engine, reference, prompt: List[int]) -> float:
    """Max |Δlogit| between two engines' prefill outputs on ``prompt``."""
    a = np.asarray(engine.prefill_logits(list(prompt)), np.float64)
    b = np.asarray(reference.prefill_logits(list(prompt)), np.float64)
    return float(np.max(np.abs(a - b)))


def check_accuracy(engine, reference, prompt: Optional[Sequence[int]] = None,
                   tolerance: Optional[float] = None) -> float:
    """Run the gate between two live engines; raises
    :class:`AccuracyBudgetExceeded` when the budget is blown, returns the
    measured error otherwise."""
    prompt = list(prompt if prompt is not None else _PROBE_PROMPT)
    prompt = [int(t) % engine.spec.vocab for t in prompt]
    precisions = set(getattr(engine, "table_precision_choices", {}
                             ).values()) or {engine.precision}
    if tolerance is None:
        tolerance = max(DEFAULT_TOLERANCES.get(p, 0.0) for p in precisions)
    err = logit_error_between(engine, reference, prompt)
    if err > tolerance:
        raise AccuracyBudgetExceeded(
            f"quantised logits deviate by {err:.4g} > accuracy budget "
            f"{tolerance:.4g} (precisions: {sorted(precisions)})")
    return err
