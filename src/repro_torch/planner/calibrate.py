"""Measurement-calibrated cost-model parameters.

The planner's :class:`~repro_torch.planner.cost.CostParams` weights
(``row_weight`` / ``group_weight`` / ``seek_weight``) were picked
analytically; this module fits them from *measured* timings so the
cost-based decisions (layout, cache key order, chunk size) track the
hardware the reproduction actually runs on:

* ``BENCH_row2col.json`` (``benchmarks/row2col_bench.py``) times the same
  prefill/decode pipelines under the ROW_CHUNK and COL_CHUNK plans across
  a seq-len × chunk-size grid.  Each measurement is matched to the cost
  model's row/group totals for that exact pipeline
  (:func:`pipeline_features`), and a least-squares fit of

      ``time_us ≈ scale · (rows + group_weight · groups) + intercept``

  recovers ``group_weight`` (``row_weight`` is the normalisation).
* ``BENCH_attn_layout.json`` (``benchmarks/attn_layout_bench.py``) times
  decode steps across the cache key orders; the analogous fit over
  ``scan_rows`` and contiguous-run counts recovers ``seek_weight`` — the
  ROADMAP's "calibrate the cache-layout locality model" item.
* ``BENCH_quant.json`` (``benchmarks/quant_bench.py``) times the same
  engine at f32/int8/nf4 payload precisions; the fit over the per-
  invocation dequant-element and stored-byte features recovers
  ``dequant_weight`` and ``byte_weight`` (the precision-planning
  weights).  Degenerate fits keep the analytic defaults, so calibration
  only moves precision decisions where the measurements support it.

:func:`choose_base_chunk_size` is the consumer: it prices every candidate
base chunk size for a spec's prefill + decode pipelines under the
(calibrated) params and returns the cheapest — the paper's Tab. 1 sweep
as an optimizer decision (``RelationalEngine(chunk_size="auto")``).
``benchmarks/chunk_sweep_bench.py`` closes the loop by re-measuring the
sweep and asserting the calibrated pick lands within one candidate step
of the measured optimum.
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.graph import infer_shapes
from repro_torch.core.llama_graph import (LlamaSpec, build_decode_graph,
                                    build_prefill_graph)
from repro_torch.core.opmap import op_map
from repro_torch.planner import cost as cost_mod
from repro_torch.planner.cost import CHUNK_CANDIDATES, CostParams
from repro_torch.planner.layout import match_matmul_site

ROW2COL_BENCH = "BENCH_row2col.json"
ATTN_BENCH = "BENCH_attn_layout.json"
QUANT_BENCH = "BENCH_quant.json"
# Payloads written before row2col_bench.py emitted head counts lack
# n_heads/n_kv; these are that benchmark's (fixed) values.  Regenerated
# payloads carry the full spec and never hit these defaults.
_BENCH_HEAD_DEFAULTS = {"n_heads": 4, "n_kv": 2}


@dataclasses.dataclass(frozen=True)
class CalibrationFit:
    """Fitted cost weights plus the fit diagnostics.

    ``scale_us`` converts one weighted cost unit (``row_weight`` rows)
    into microseconds; ``intercept_us`` absorbs per-invocation overhead
    the row model does not see (dispatch, non-matmul steps).  Only the
    *ratios* in ``params`` matter to the planner's argmin decisions.
    """

    params: CostParams
    scale_us: float
    intercept_us: float
    residual_us: float     # RMS residual over the fitted points
    n_points: int


# ---------------------------------------------------------------------------
# Cost features of a compiled pipeline
# ---------------------------------------------------------------------------


def _spec_from_payload(sp: Dict) -> LlamaSpec:
    return LlamaSpec(
        vocab=sp["vocab"], d_model=sp["d_model"], n_layers=sp["n_layers"],
        n_heads=sp.get("n_heads", _BENCH_HEAD_DEFAULTS["n_heads"]),
        n_kv=sp.get("n_kv", _BENCH_HEAD_DEFAULTS["n_kv"]),
        d_ff=sp.get("d_ff", sp["d_model"] * 2), rope_theta=10000.0)


def step_features(spec: LlamaSpec, kind: str, T: int, cs: int,
                  mode: str = "off",
                  cache_len: Optional[int] = None,
                  params: Optional[CostParams] = None,
                  batch: Optional[int] = None
                  ) -> Dict[str, Tuple[int, int]]:
    """Per-step ``{step_name: (rows, groups)}`` the matmul cost model
    predicts for one invocation of the ``kind`` pipeline at base chunk
    size ``cs`` — only the matched matmul sites appear (the priced steps).

    This is the join key for observed per-step timings: the step names
    match both ``run_pipeline``'s ``cat="step"`` spans and the
    ``StatementProvenance.step`` tags on the generated SQL, so a
    :func:`repro_torch.obs.drift.drift_report` (or
    :func:`fit_from_step_timings`) can pair each prediction with where the time actually went.

    ``mode`` selects which layout each matched site is priced under:
    ``"off"`` (all ROW_CHUNK), ``"col"`` (column wherever legal — the
    row2col benchmark's forced mode) or ``"auto"`` (the per-site cheaper
    one *under* ``params`` — pass the calibrated weights so the features
    describe the plan the calibrated planner would actually build).
    Raises ``ValueError`` when ``cs`` is illegal under the compiler's
    clamp rule (each chunked width must be divisible by
    ``min(cs, width)`` — candidates above a width chunk it whole), which
    callers use to filter candidate grids.

    ``batch`` > 0 prices the *batched* decode graph (the serving path's
    per-tick pipeline, step names ``..@seq``-keyed) instead of the
    single-sequence one, so online drift checks against a continuous
    batcher join on the step names the batcher actually runs.
    """
    g = (build_prefill_graph(spec, T, cache_len=cache_len)
         if kind == "prefill" else
         build_decode_graph(spec, cache_len=cache_len or max(T, 16),
                            batch=batch or 0))
    infer_shapes(g)
    pipe = op_map(g, chunk_size=cs)
    p = params or CostParams()
    out: Dict[str, Tuple[int, int]] = {}
    for step in pipe.steps:
        if step.kind != "bind":
            continue
        site = match_matmul_site(step.name, step.rel.plan)
        if site is None:
            continue
        Ts = site.seq_len
        out_total = site.n_heads * site.out_features
        row_c = cost_mod.row_chunk_cost(Ts, site.in_features, out_total,
                                        site.row_chunk)
        if site.is_head_site:
            col_c = cost_mod.colh_chunk_cost(Ts, site.n_heads,
                                             site.in_features,
                                             site.out_features,
                                             site.col_chunk)
        else:
            col_c = cost_mod.col_chunk_cost(Ts, site.in_features, out_total,
                                            site.col_chunk)
        if mode == "off":
            c = row_c
        elif mode == "col":
            c = col_c
        else:  # auto: the cheaper side under the (calibrated) weights
            c = col_c if col_c.total(p) < row_c.total(p) else row_c
        out[step.name] = (
            c.scan_rows + c.join_rows + c.aux_rows + c.rechunk_rows,
            c.agg_groups + c.rechunk_groups)
    return out


def pipeline_features(spec: LlamaSpec, kind: str, T: int, cs: int,
                      mode: str = "off",
                      cache_len: Optional[int] = None,
                      params: Optional[CostParams] = None
                      ) -> Tuple[int, int]:
    """(rows, groups) the matmul cost model predicts one invocation of the
    ``kind`` pipeline touches at base chunk size ``cs`` — the sum of
    :func:`step_features` over the pipeline's matched matmul sites (see
    there for ``mode`` semantics and the chunk-clamp ``ValueError``)."""
    feats = step_features(spec, kind, T, cs, mode, cache_len=cache_len,
                          params=params)
    return (sum(r for r, _ in feats.values()),
            sum(g for _, g in feats.values()))


def cache_features(spec: LlamaSpec, cs: int, cache_len: int,
                   layout: str = "row_chunk",
                   new_tokens: int = 1) -> Tuple[int, int]:
    """(scan_rows, seek_segments) of one decode invocation's cache traffic
    (summed over every K/V cache table)."""
    dh = spec.head_dim
    nch = max(1, dh // min(cs, dh))
    c = cost_mod.cache_layout_cost(layout, cache_len, spec.n_kv, nch,
                                   new_tokens=new_tokens)
    n_tables = 2 * spec.n_layers
    return (n_tables * c.scan_rows,
            n_tables * (c.read_segments + c.write_segments))


# ---------------------------------------------------------------------------
# Least-squares fits
# ---------------------------------------------------------------------------


def _lstsq(A: np.ndarray, b: np.ndarray) -> Tuple[np.ndarray, float]:
    x, *_ = np.linalg.lstsq(A, b, rcond=None)
    resid = float(np.sqrt(np.mean((b - A @ x) ** 2)))
    return x, resid


def _log_fallback(reason: str, **fields) -> None:
    """Structured record of a calibration fallback through the obs event
    logger (lazy import — the planner must not hard-depend on repro_torch.obs):
    a fit that silently keeps its analytic defaults is the failure mode
    the drift report exists to catch, so make the keep visible."""
    from repro_torch.obs.log import log_event
    log_event("calibration_fallback", reason=reason, **fields)


def fit_matmul_weights(points: Sequence[Tuple[float, float, float]]
                       ) -> Tuple[float, float, float, float]:
    """Fit ``time ≈ scale·rows + scale·group_weight·groups + intercept``.

    ``points``: (rows, groups, time_us) tuples.  Returns
    ``(group_weight, scale_us, intercept_us, rms_residual)``; negative
    fitted weights are clipped to zero (a weight the data cannot resolve
    must not flip decisions).
    """
    A = np.array([[r, g, 1.0] for r, g, _ in points], dtype=np.float64)
    b = np.array([t for _, _, t in points], dtype=np.float64)
    x, resid = _lstsq(A, b)
    s_r, s_g, c0 = x
    if s_r <= 0:  # degenerate measurement set: keep the analytic default
        _log_fallback("non_positive_row_scale", fit="matmul",
                      row_scale=float(s_r), n_points=len(points),
                      kept="group_weight")
        return CostParams().group_weight, max(s_r, 1e-9), c0, resid
    return max(s_g / s_r, 0.0), s_r, c0, resid


def fit_cache_weights(points: Sequence[Tuple[float, float, float]]
                      ) -> Tuple[float, float, float, float]:
    """Fit ``time ≈ scale·scan_rows + scale·seek_weight·segments + c0``.

    ``points``: (scan_rows, segments, time_us).  Returns
    ``(seek_weight, scale_us, intercept_us, rms_residual)`` with the same
    clipping convention as :func:`fit_matmul_weights`.
    """
    A = np.array([[s, k, 1.0] for s, k, _ in points], dtype=np.float64)
    b = np.array([t for _, _, t in points], dtype=np.float64)
    x, resid = _lstsq(A, b)
    s_r, s_k, c0 = x
    if s_r <= 0:
        _log_fallback("non_positive_row_scale", fit="cache",
                      row_scale=float(s_r), n_points=len(points),
                      kept="seek_weight")
        return CostParams().seek_weight, max(s_r, 1e-9), c0, resid
    return max(s_k / s_r, 0.0), s_r, c0, resid


def matmul_points_from_payload(payload: Dict) -> List[Tuple[float, float,
                                                            float]]:
    """(rows, groups, time_us) points from a BENCH_row2col-format payload:
    one point per (seq_len, chunk_size) × {prefill, decode} × {off, col}
    measurement, with the features rebuilt for that exact pipeline."""
    spec = _spec_from_payload(payload["spec"])
    points = []
    for rec in payload["results"]:
        T, cs = rec["seq_len"], rec["chunk_size"]
        cache_len = T + 8  # row2col_bench's setting
        for kind, Teff in (("prefill", T), ("decode", 1)):
            for mode in ("off", "col"):
                key = f"{kind}_{mode}_us"
                if key not in rec:
                    continue
                rows, groups = pipeline_features(spec, kind, Teff, cs,
                                                 mode, cache_len=cache_len)
                points.append((rows, groups, rec[key]))
    return points


def fit_quant_weights(points: Sequence[Tuple[float, float, float, float]],
                      dequant_times_us: Optional[Sequence[Optional[float]]]
                      = None,
                      cold_points: Optional[Sequence[Tuple[str, float,
                                                           float, float]]]
                      = None
                      ) -> Tuple[float, float, float, float, float]:
    """Fit ``time ≈ s·feat + s·dq·dequant_elems + s·bw·bytes + c0``.

    ``points``: (weighted_row_feature, dequant_elems, table_bytes,
    time_us) — one per (pipeline kind, precision) measurement from
    ``BENCH_quant.json``.  Returns ``(dequant_weight, byte_weight,
    scale_us, intercept_us, rms_residual)``.  Degenerate directions keep
    safe values: a non-positive row scale, or a non-positive *dequant*
    slope (noise measuring quantised decode as faster than f32), keeps
    the analytic dequant default — clamping it to zero would make
    dequantisation free and flip ``precision="auto"`` to quantise
    everything with no memory pressure.  A non-positive byte slope clamps
    to zero, which is the conservative direction (f32 keeps winning).

    ``dequant_times_us`` aligns with ``points``: the traced
    ``dequant_project`` operator-class time (µs) of that measurement —
    :meth:`repro_torch.obs.dbtrace.TickTrace.class_times_us` over one profiled
    tick — or ``None`` where no trace exists.  When any usable pair is
    present, the dequant slope is fitted *directly* from the traced
    operator times (through-origin regression on dequant elements), and
    only the row-feature / byte / intercept directions come from the
    total times.  This is what rescues the dispatch-dominated case: the
    whole-pipeline totals move by microseconds of dispatch noise per
    precision, so the joint fit cannot resolve the dequant direction,
    but the profiler's per-operator attribution measures it in
    isolation.

    ``cold_points``: (kind, bytes, dequant_elems, time_us) quads from
    the disk-backed cold-cache timings (``{prefill,decode}_cold_us`` in
    BENCH_quant) — the counterpart measurement for the *byte* direction.
    Warm totals barely move with stored bytes (everything is resident),
    so the joint fit's byte slope is noise-dominated; the cold runs
    re-stream the working set every tick, making byte traffic the
    leading term.  The byte slope is fitted across precisions with one
    shared slope, a dequant-elements nuisance column (the reload path
    re-dequantises what it re-streams, so quantised cold runs pay extra
    time that is *not* byte traffic — without the column it confounds
    the byte slope negative), and a per-kind intercept (row features are
    near-constant within a kind).  A positive fitted slope overrides the
    joint fit's ``byte_weight``.
    """
    base = CostParams()
    s_d_traced: Optional[float] = None
    if dequant_times_us is not None:
        pairs = [(d, t) for (_, d, _, _), t
                 in zip(points, dequant_times_us)
                 if t is not None and d > 0]
        denom = sum(d * d for d, _ in pairs)
        if pairs and denom > 0:
            slope = sum(d * t for d, t in pairs) / denom
            if slope > 0:
                s_d_traced = slope
            else:
                _log_fallback("non_positive_traced_dequant_slope",
                              fit="quant", dequant_slope=float(slope),
                              n_traced=len(pairs))
    A = np.array([[f, d, b, 1.0] for f, d, b, _ in points],
                 dtype=np.float64)
    t = np.array([tt for *_, tt in points], dtype=np.float64)
    x, resid = _lstsq(A, t)
    s_r, s_d, s_b, c0 = x
    if s_r <= 0:
        _log_fallback("non_positive_row_scale", fit="quant",
                      row_scale=float(s_r), n_points=len(points),
                      kept="dequant_weight,byte_weight")
        return base.dequant_weight, base.byte_weight, max(s_r, 1e-9), \
            c0, resid
    bw = max(s_b / s_r, 0.0)
    if cold_points:
        kinds = sorted({k for k, *_ in cold_points})
        if len(cold_points) >= len(kinds) + 2:
            A2 = np.array(
                [[b, d] + [1.0 if k == kk else 0.0 for kk in kinds]
                 for k, b, d, _ in cold_points], dtype=np.float64)
            t2 = np.array([tt for *_, tt in cold_points],
                          dtype=np.float64)
            x2, _ = _lstsq(A2, t2)
            if x2[0] > 0:
                bw = x2[0] / s_r
            else:
                _log_fallback("non_positive_cold_byte_slope", fit="quant",
                              byte_slope=float(x2[0]),
                              n_cold=len(cold_points))
        else:
            _log_fallback("too_few_cold_points", fit="quant",
                          n_cold=len(cold_points), need=len(kinds) + 2)
    if s_d_traced is not None:
        # the traced operator slope pins the dequant direction; the
        # row/byte/intercept directions still come from the totals
        return s_d_traced / s_r, bw, s_r, c0, resid
    if s_d <= 0:
        _log_fallback("non_positive_dequant_slope", fit="quant",
                      dequant_slope=float(s_d), n_points=len(points),
                      kept="dequant_weight")
    dq = base.dequant_weight if s_d <= 0 else s_d / s_r
    return dq, bw, s_r, c0, resid


def quant_points_from_payload(payload: Dict,
                              params: Optional[CostParams] = None
                              ) -> List[Tuple[float, float, float, float]]:
    """(row_feature, dequant_elems, bytes, time_us) points from a
    BENCH_quant payload — one per (prefill/decode, precision) pair, with
    the matmul row/group feature rebuilt for that pipeline (precision
    changes neither rows nor groups; it moves bytes and dequant work)."""
    spec = _spec_from_payload(payload["spec"])
    cs = payload["chunk_size"]
    T = payload.get("prompt_tokens", 8)
    cache_len = payload.get("cache_len", T + 8)
    p = params or CostParams()
    feats = {}
    for kind, Teff in (("prefill", T), ("decode", 1)):
        rows, groups = pipeline_features(spec, kind, Teff, cs, "auto",
                                         cache_len=cache_len, params=p)
        feats[kind] = rows + p.group_weight * groups
    points = []
    for rec in payload["results"]:
        for kind in ("prefill", "decode"):
            key = f"{kind}_us"
            if key not in rec:
                continue
            points.append((feats[kind],
                           rec.get("dequant_cost_elements", 0.0),
                           rec["resident_weight_bytes"], rec[key]))
    return points


def dequant_times_from_payload(payload: Dict
                               ) -> Optional[List[Optional[float]]]:
    """Traced ``dequant_project`` operator-class times (µs), aligned with
    :func:`quant_points_from_payload`'s point order.

    ``quant_bench.py`` stores them per record under
    ``class_times_us[kind]["dequant_project"]`` when duckdb is importable
    at bench time (one profiled decode tick attributed through
    ``StatementProvenance``).  Entries are ``None`` where the record
    carries no trace for that kind; an f32 record with a trace but no
    dequant operators reads as a true 0 µs measurement.  Returns ``None``
    when the whole payload is untraced (older files fit exactly as
    before).
    """
    times: List[Optional[float]] = []
    any_traced = False
    for rec in payload["results"]:
        traced = rec.get("class_times_us") or {}
        for kind in ("prefill", "decode"):
            if f"{kind}_us" not in rec:
                continue
            if kind in traced:
                times.append(float(traced[kind].get("dequant_project",
                                                    0.0)))
                any_traced = True
            else:
                times.append(None)
    return times if any_traced else None


def cold_points_from_payload(payload: Dict
                             ) -> List[Tuple[str, float, float, float]]:
    """(kind, bytes, dequant_elems, time_us) quads from the disk-backed
    cold-cache timings (``{prefill,decode}_cold_us``) in a BENCH_quant
    payload — the byte-direction measurement :func:`fit_quant_weights`
    fits the cold byte slope from.  Empty for payloads predating the
    cold mode.
    """
    points = []
    for rec in payload["results"]:
        for kind in ("prefill", "decode"):
            key = f"{kind}_cold_us"
            if key in rec:
                points.append((kind, float(rec["resident_weight_bytes"]),
                               float(rec.get("dequant_cost_elements",
                                             0.0)),
                               float(rec[key])))
    return points


def cache_points_from_payload(payload: Dict) -> List[Tuple[float, float,
                                                           float]]:
    """(scan_rows, segments, time_us) points from a BENCH_attn_layout
    payload — one point per (cache_len, layout) decode measurement."""
    spec = _spec_from_payload(payload["spec"])
    points = []
    for rec in payload["results"]:
        cs = rec["chunk_size"]
        for layout in payload["layouts"]:
            key = f"decode_{layout}_us"
            if key not in rec:
                continue
            scan, seeks = cache_features(spec, cs, rec["cache_len"], layout)
            points.append((scan, seeks, rec[key]))
    return points


def _resolve_bench(path: Optional[str]) -> Optional[str]:
    """Find a benchmark JSON: as given (cwd-relative or absolute), else
    next to the source checkout's root (where the benchmarks write them).
    Returns None — with a warning — when neither exists, so a fit that
    silently kept its analytic defaults is at least visible."""
    if not path:
        return None
    if os.path.exists(path):
        return path
    if not os.path.isabs(path):
        root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "..", "..", "..")
        cand = os.path.normpath(os.path.join(root, path))
        if os.path.exists(cand):
            return cand
    warnings.warn(f"calibration data {path!r} not found; the affected "
                  "cost weights keep their analytic defaults")
    _log_fallback("bench_file_missing", path=path)
    return None


def fit_cost_params(row2col_path: Optional[str] = ROW2COL_BENCH,
                    attn_path: Optional[str] = ATTN_BENCH,
                    base: Optional[CostParams] = None,
                    quant_path: Optional[str] = QUANT_BENCH
                    ) -> CalibrationFit:
    """Fit :class:`CostParams` from the benchmark JSONs.

    Relative paths resolve against the CWD first, then the repo root
    (where ``benchmarks/run.py`` writes them).  Missing files warn and
    leave the corresponding weights at their analytic defaults (the fit
    degrades gracefully to ``base``).  ``BENCH_quant.json`` supplies the
    precision-planning weights: ``dequant_weight`` (per dequantised
    element) and ``byte_weight`` (per stored byte streamed).  The
    returned params keep ``row_weight = 1`` — only ratios matter.
    """
    base = base or CostParams()
    gw, scale, c0, resid, n = (base.group_weight, 1.0, 0.0, 0.0, 0)
    row2col_path = _resolve_bench(row2col_path)
    if row2col_path:
        with open(row2col_path) as f:
            points = matmul_points_from_payload(json.load(f))
        if len(points) >= 4:
            gw, scale, c0, resid = fit_matmul_weights(points)
            n += len(points)
        else:
            warnings.warn(
                f"{row2col_path!r} holds only {len(points)} measurement(s) "
                "(need 4 for a determined fit); group_weight keeps its "
                "analytic default")
            _log_fallback("too_few_points", fit="matmul",
                          path=row2col_path, n_points=len(points), need=4)
    sw = base.seek_weight
    attn_path = _resolve_bench(attn_path)
    if attn_path:
        with open(attn_path) as f:
            cpoints = cache_points_from_payload(json.load(f))
        if len(cpoints) >= 4:
            sw, _, _, _ = fit_cache_weights(cpoints)
            n += len(cpoints)
        else:
            warnings.warn(
                f"{attn_path!r} holds only {len(cpoints)} measurement(s) "
                "(need 4 for a determined fit); seek_weight keeps its "
                "analytic default")
            _log_fallback("too_few_points", fit="cache",
                          path=attn_path, n_points=len(cpoints), need=4)
    dq, bw = base.dequant_weight, base.byte_weight
    quant_path = _resolve_bench(quant_path)
    if quant_path:
        with open(quant_path) as f:
            qpayload = json.load(f)
        qpoints = quant_points_from_payload(
            qpayload, params=dataclasses.replace(base, group_weight=gw))
        qtimes = dequant_times_from_payload(qpayload)
        qcold = cold_points_from_payload(qpayload)
        if len(qpoints) >= 5:  # 4 unknowns: need an overdetermined system
            dq, bw, _, _, _ = fit_quant_weights(qpoints, qtimes,
                                                cold_points=qcold or None)
            n += len(qpoints) + len(qcold)
        else:
            warnings.warn(
                f"{quant_path!r} holds only {len(qpoints)} measurement(s) "
                "(need 5 for a determined fit); dequant/byte weights keep "
                "their analytic defaults")
            _log_fallback("too_few_points", fit="quant",
                          path=quant_path, n_points=len(qpoints), need=5)
    params = dataclasses.replace(base, row_weight=1.0, group_weight=gw,
                                 seek_weight=sw, dequant_weight=dq,
                                 byte_weight=bw)
    return CalibrationFit(params=params, scale_us=scale, intercept_us=c0,
                          residual_us=resid, n_points=n)


def fit_from_step_timings(features: Dict[str, Tuple[float, float]],
                          observed_us: Dict[str, float],
                          base: Optional[CostParams] = None
                          ) -> CalibrationFit:
    """Calibrate ``group_weight`` from *observed* per-step timings — the
    plan-feedback calibration source the benchmarks can't provide.

    ``features``: step → (rows, groups) from :func:`step_features`;
    ``observed_us``: step → measured µs, from a traced ``run_pipeline``
    (``TraceRecorder.step_times_us()``) or a DB-profiled tick
    (``repro_torch.obs.profile.step_times_us``).  Each priced step is one fit
    point, so a single traced invocation yields an overdetermined system
    (unlike the benchmark fits, which get one point per whole-pipeline
    measurement).  Steps present on only one side are ignored; fewer than
    4 joined points keeps the analytic defaults (with a structured
    fallback event).  The fitted scale/intercept feed
    ``repro_torch.obs.drift.drift_report(scale_us=..., intercept_us=...)`` to
    measure later runs' absolute drift against this calibration.
    """
    base = base or CostParams()
    common = sorted(set(features) & set(observed_us))
    points = [(features[s][0], features[s][1], observed_us[s])
              for s in common]
    if len(points) < 4:
        warnings.warn(
            f"only {len(points)} step timing(s) join the cost features "
            "(need 4 for a determined fit); group_weight keeps its "
            "analytic default")
        _log_fallback("too_few_points", fit="step_timings",
                      n_points=len(points), need=4)
        return CalibrationFit(params=base, scale_us=1.0, intercept_us=0.0,
                              residual_us=0.0, n_points=len(points))
    gw, scale, c0, resid = fit_matmul_weights(points)
    params = dataclasses.replace(base, row_weight=1.0, group_weight=gw)
    return CalibrationFit(params=params, scale_us=scale, intercept_us=c0,
                          residual_us=resid, n_points=len(points))


# ---------------------------------------------------------------------------
# Chunk-size choice (the Tab. 1 sweep as an optimizer decision)
# ---------------------------------------------------------------------------


def choose_base_chunk_size(spec: LlamaSpec, cache_len: int = 1024,
                           prefill_tokens: int = 32,
                           candidates: Optional[Sequence[int]] = None,
                           params: Optional[CostParams] = None,
                           mix: Tuple[float, float] = (1.0, 1.0)) -> int:
    """Cost-based choice of the engine's base chunk size.

    Prices one prefill invocation (``prefill_tokens`` tokens) and one
    decode step — matmul rows/groups at the per-site cheaper layout plus
    the decode cache locality term — for every candidate that compiles
    under the compiler's clamp rule (each chunked width divisible by
    ``min(candidate, width)``; a candidate above a width chunks that
    dimension whole, so over-width candidates degenerate to the same
    physical plan and the tie goes to the smaller nominal size), and
    returns the argmin of ``mix[0]·prefill + mix[1]·decode``.
    """
    p = params or CostParams()
    cands = tuple(candidates or CHUNK_CANDIDATES)
    best: Optional[Tuple[float, int]] = None
    for cs in cands:
        try:
            rp, gp = pipeline_features(spec, "prefill", prefill_tokens, cs,
                                       "auto", cache_len=cache_len,
                                       params=p)
            rd, gd = pipeline_features(spec, "decode", 1, cs, "auto",
                                       cache_len=cache_len, params=p)
        except ValueError:
            continue  # cs does not divide the model's widths
        scan_d, seek_d = cache_features(spec, cs, cache_len)
        scan_p, seek_p = cache_features(spec, cs, cache_len,
                                        new_tokens=prefill_tokens)
        prefill_cost = (p.row_weight * (rp + scan_p) + p.group_weight * gp
                        + p.seek_weight * seek_p)
        decode_cost = (p.row_weight * (rd + scan_d) + p.group_weight * gd
                       + p.seek_weight * seek_d)
        total = mix[0] * prefill_cost + mix[1] * decode_cost
        if best is None or (total, cs) < best:
            best = (total, cs)
    if best is None:
        raise ValueError(
            f"no candidate chunk size in {cands} divides the model widths")
    return best[1]
