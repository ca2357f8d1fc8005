"""The port's request-scoped trace context, flight recorder and drift
watchdog against the JAX package's.

The reference's ``tests/test_flight.py`` runs on both packages
(``repro.obs`` / ``repro.serving.watchdog`` and their copies under
``repro_torch``); beside it, the same scripted ticks, events and pins on a
fixed clock give equal ``FlightRecorder.to_dict`` / ``request_trace`` /
``to_chrome`` dumps, the same perturbed window gives the watchdog the same
drift report and refit, and a re-plan landing in the middle of a live
decode session leaves the port's tokens equal to the JAX engine's.
"""

import json
import threading
import types
import warnings

import pytest

torch = pytest.importorskip("torch")

import repro.obs as jobs  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro.core.llama_graph import LlamaSpec as JSpec  # noqa: E402
from repro.core.llama_graph import init_llama_params  # noqa: E402
from repro.serving.engine import RelationalEngine as JEngine  # noqa: E402
from repro.serving.watchdog import DriftWatchdog as JWatchdog  # noqa: E402
from repro_torch.core.llama_graph import LlamaSpec  # noqa: E402
from repro_torch.serving.engine import RelationalEngine  # noqa: E402
from repro_torch.serving.watchdog import DriftWatchdog  # noqa: E402

SPEC_ARGS = dict(vocab=16, d_model=8, n_layers=1, n_heads=2, n_kv=1,
                 d_ff=16, rope_theta=10000.0)
PARAMS = init_llama_params(JSpec(**SPEC_ARGS), seed=0)


def _jax_engine(**kw):
    return JEngine(JSpec(**SPEC_ARGS), PARAMS, chunk_size=4, max_len=16,
                   **kw)


def _torch_engine(**kw):
    return RelationalEngine(LlamaSpec(**SPEC_ARGS), PARAMS, chunk_size=4,
                            max_len=16, device="cpu", **kw)


JAX = types.SimpleNamespace(obs=jobs, Watchdog=JWatchdog, engine=_jax_engine)
TORCH = types.SimpleNamespace(obs=tobs, Watchdog=DriftWatchdog,
                              engine=_torch_engine)
PKGS = [pytest.param(JAX, id="jax"), pytest.param(TORCH, id="torch")]


def _step_span(obs, name, ts, dur, **args):
    return obs.SpanEvent(name=name, cat="step", ts_us=ts, dur_us=dur,
                         depth=0, args=args)


def _fixed_clock():
    t = [100.0]

    def clock():
        t[0] += 0.000125
        return t[0]
    return clock


# -- TestTraceContext --------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_trace_ids_are_short_hex_and_unique(pkg):
    ids = {pkg.obs.new_trace_id() for _ in range(64)}
    assert len(ids) == 64
    assert all(len(t) == 16 and int(t, 16) >= 0 for t in ids)


@pytest.mark.parametrize("pkg", PKGS)
def test_activate_scopes_and_nests(pkg):
    obs = pkg.obs
    assert obs.current_context() is None
    outer = obs.TraceContext.for_request(1, "aa", phase="prefill")
    inner = obs.TraceContext(request_ids=(1, 2), trace_ids=("aa", "bb"),
                             phase="decode", tick=7)
    with obs.activate(outer):
        assert obs.current_context() is outer
        with obs.activate(inner):
            assert obs.current_context().phase == "decode"
        with obs.activate(None):
            assert obs.current_context() is None
        assert obs.current_context() is outer
    assert obs.current_context() is None


@pytest.mark.parametrize("pkg", PKGS)
def test_span_auto_attaches_context(pkg):
    obs = pkg.obs
    rec = obs.TraceRecorder()
    ctx = obs.TraceContext(request_ids=(3, 4), trace_ids=("x1", "x2"),
                           phase="decode", tick=9)
    with obs.activate(ctx):
        with rec.span("attn", cat="step", phase="explicit"):
            pass
        rec.add_span("fetch", cat="pager", ts_us=0.0, dur_us=1.0)
    with rec.span("outside", cat="step"):
        pass
    by_name = {e.name: e.args for e in rec.events}
    assert by_name["attn"]["rids"] == [3, 4]
    assert by_name["attn"]["trace_ids"] == ["x1", "x2"]
    assert by_name["attn"]["phase"] == "explicit"
    assert by_name["fetch"]["tick"] == 9
    assert "rids" not in by_name["outside"]


@pytest.mark.parametrize("pkg", PKGS)
def test_context_does_not_cross_threads(pkg):
    obs = pkg.obs
    seen = {}
    ctx = obs.TraceContext.for_request(5, "cc")

    def worker():
        seen["bare"] = obs.current_context()
        with obs.activate(ctx):
            seen["activated"] = obs.current_context()

    with obs.activate(ctx):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    assert seen["bare"] is None
    assert seen["activated"] is ctx


# -- TestLogEventFlightForwarding -------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_event_carries_context_and_lands_in_flight(pkg):
    obs = pkg.obs
    flight = obs.FlightRecorder()
    obs.set_flight_recorder(flight)
    try:
        ctx = obs.TraceContext.for_request(8, "ee", phase="decode", tick=3)
        with obs.activate(ctx):
            obs.log_event("unit_test_event", detail="x")
        obs.log_event("unit_test_event_bare")
    finally:
        obs.set_flight_recorder(None)
    evs = flight.events()
    assert [e.event for e in evs] == ["unit_test_event",
                                     "unit_test_event_bare"]
    assert evs[0].fields["rids"] == [8]
    assert evs[0].fields["trace_ids"] == ["ee"]
    assert evs[0].fields["detail"] == "x"
    assert "rids" not in evs[1].fields
    assert evs[0].ts_us <= evs[1].ts_us


# -- TestFlightRecorder -------------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_ring_bounded_with_eviction(pkg):
    fl = pkg.obs.FlightRecorder(capacity=4)
    for i in range(10):
        fl.record_tick("decode", tick=i, request_ids=(i,),
                       trace_ids=(f"t{i}",))
    assert len(fl.ticks()) == 4 and fl.dropped_ticks == 6
    assert [t.tick for t in fl.ticks()] == [6, 7, 8, 9]
    assert fl.request_ticks("t0") == [] and fl.request_ticks("0") == []
    assert fl.request_ticks("t9")[0].tick == 9


@pytest.mark.parametrize("pkg", PKGS)
def test_index_accepts_rid_and_trace_id(pkg):
    fl = pkg.obs.FlightRecorder()
    fl.record_admission(7, "abc123", wall_us=50.0)
    fl.record_tick("prefill", tick=1, request_ids=(7,),
                   trace_ids=("abc123",))
    assert [t.kind for t in fl.request_ticks("abc123")] == \
        ["admission", "prefill"]
    assert fl.request_ticks("7") == fl.request_ticks("abc123")


@pytest.mark.parametrize("pkg", PKGS)
def test_pinned_exemplars_survive_eviction(pkg):
    fl = pkg.obs.FlightRecorder(capacity=2, max_pinned=2)
    fl.record_tick("decode", tick=0, request_ids=(1,), trace_ids=("slow",))
    fl.pin("slow", reason="slo")
    fl.record_tick("decode", tick=1, request_ids=(1, 2),
                   trace_ids=("slow", "fast"))
    for i in range(2, 7):
        fl.record_tick("decode", tick=i, trace_ids=(f"x{i}",))
    assert len(fl.ticks()) == 2
    assert [t.tick for t in fl.request_ticks("slow")] == [0, 1]
    assert all(t.pinned for t in fl.request_ticks("slow"))
    fl.pin("p1")
    fl.pin("p2")
    assert "slow" not in fl.to_dict()["pinned"]


@pytest.mark.parametrize("pkg", PKGS)
def test_step_times_us_windowing(pkg):
    obs = pkg.obs
    fl = obs.FlightRecorder()
    fl.record_tick("decode", spans=(_step_span(obs, "a", 0, 100.0),
                                    _step_span(obs, "b", 100, 50.0)))
    fl.record_tick("prefill", spans=(_step_span(obs, "a", 200, 999.0),))
    fl.record_tick("decode", spans=(_step_span(obs, "a", 300, 10.0),))
    got, last = fl.step_times_us(kind="decode", cat="step")
    assert got == {"a": 110.0, "b": 50.0}
    fl.record_tick("decode", spans=(_step_span(obs, "b", 400, 7.0),))
    got2, last2 = fl.step_times_us(kind="decode", cat="step",
                                   after_seq=last)
    assert got2 == {"b": 7.0} and last2 > last
    assert fl.step_times_us(kind="decode", cat="step",
                            after_seq=last2)[0] == {}


@pytest.mark.parametrize("pkg", PKGS)
def test_request_trace_reconstructs_end_to_end(pkg):
    obs = pkg.obs
    fl = obs.FlightRecorder()
    fl.record_admission(3, "tid3", wall_us=40.0, tick=0)
    fl.record_tick(
        "prefill", tick=1, request_ids=(3,), trace_ids=("tid3",),
        wall_us=100.0,
        spans=(_step_span(obs, "embed", 50, 60.0, trace_ids=["tid3"]),
               _step_span(obs, "attn", 110, 40.0, trace_ids=["tid3"])))
    fl.record_tick(
        "decode", tick=2, request_ids=(3, 4), trace_ids=("tid3", "tid4"),
        wall_us=80.0,
        spans=(_step_span(obs, "attn", 200, 80.0,
                          trace_ids=["tid3", "tid4"]),
               _step_span(obs, "other_only", 200, 5.0,
                          trace_ids=["tid4"])))
    trace = fl.request_trace("tid3")
    assert trace["request_id"] == 3 and trace["trace_id"] == "tid3"
    assert [t["kind"] for t in trace["ticks"]] == \
        ["admission", "prefill", "decode"]
    assert trace["wall_us"] == pytest.approx(220.0)
    assert 0.0 < trace["coverage"] <= 1.0
    names = [e["name"] for e in trace["traceEvents"]]
    assert "other_only" not in names
    assert "embed" in names and "attn" in names
    assert fl.request_trace("3")["trace_id"] == "tid3"
    assert fl.request_trace("deadbeef") is None


@pytest.mark.parametrize("pkg", PKGS)
def test_coverage_counts_depth0_only_and_clips(pkg):
    obs = pkg.obs
    fl = obs.FlightRecorder()
    t = fl.record_tick(
        "decode", wall_us=100.0,
        spans=(_step_span(obs, "a", 0, 80.0),
               obs.SpanEvent(name="sub", cat="op", ts_us=0, dur_us=70.0,
                             depth=1),
               _step_span(obs, "b", 80, 40.0)))
    assert t.named_us() == pytest.approx(120.0)
    assert t.coverage() == 1.0
    t2 = fl.record_tick("decode", wall_us=100.0,
                        spans=(_step_span(obs, "a", 0, 25.0),))
    assert t2.coverage() == pytest.approx(0.25)


@pytest.mark.parametrize("pkg", PKGS)
def test_to_dict_and_chrome_are_serialisable(pkg):
    obs = pkg.obs
    fl = obs.FlightRecorder()
    fl.record_admission(1, "t1", wall_us=10.0)
    fl.record_tick("decode", spans=(_step_span(obs, "a", 0, 5.0),),
                   wall_us=5.0, request_ids=(1,), trace_ids=("t1",))
    fl.record_event("evt", {"k": "v"})
    d = fl.to_dict()
    assert d["retained_ticks"] == 2 and d["indexed_requests"] >= 1
    assert d["events"][0]["event"] == "evt"
    json.dumps(d)
    chrome = fl.to_chrome()
    assert {e["ph"] for e in chrome["traceEvents"]} == {"X", "i"}
    json.dumps(chrome)


def _scripted_flight(obs):
    """One scripted serving history on a fixed clock: admissions, a
    prefill and batched decode ticks with real spans, events, an SLO pin
    and ring eviction."""
    tracer = obs.TraceRecorder(clock=_fixed_clock())
    fl = obs.FlightRecorder.for_tracer(tracer, capacity=6,
                                       event_capacity=4, max_pinned=2)
    for rid in range(3):
        tid = f"{rid:016x}"
        fl.record_admission(rid, tid, wall_us=12.5 * (rid + 1), tick=rid)
        ctx = obs.TraceContext.for_request(rid, tid, phase="prefill",
                                           tick=rid)
        n0 = len(tracer.events)
        with obs.activate(ctx):
            with tracer.span("session_env", cat="decoder"):
                pass
            with tracer.span("embed", cat="step", kind="bind",
                             ops=["join"], tables=["vocabulary"]):
                with tracer.span("join", cat="op", node="Join"):
                    pass
        fl.record_tick("prefill", spans=tracer.drain(n0), wall_us=900.0,
                       tick=rid, request_ids=(rid,), trace_ids=(tid,))
    for tick in range(3, 9):
        rids = (0, 1, 2)
        tids = tuple(f"{r:016x}" for r in rids)
        ctx = obs.TraceContext(request_ids=rids, trace_ids=tids,
                               phase="decode", tick=tick)
        n0 = len(tracer.events)
        with obs.activate(ctx):
            with tracer.span("cache_views", cat="decoder", outcome="hit"):
                pass
            for step in ("rmsnorm", "attn_output", "lm_head"):
                with tracer.span(step, cat="step", kind="bind"):
                    pass
            tracer.add_span("pager_fetch:w", "pager", 1.0, 2.0, depth=1,
                            bytes=64)
        fl.record_event("beat", {"tick": tick})
        fl.record_tick("decode", spans=tracer.drain(n0),
                       wall_us=50.0 * tick, tick=tick, request_ids=rids,
                       trace_ids=tids)
        if tick == 4:
            fl.pin(tids[1], reason="slo")
    return fl


def test_flight_dumps_match_jax():
    """The same scripted history gives the same ``to_dict``,
    ``request_trace`` (by trace id and by request id) and Chrome trace
    in both packages, pinned exemplars and evictions included."""
    got, want = _scripted_flight(tobs), _scripted_flight(jobs)
    assert json.dumps(got.to_dict(), sort_keys=True) == json.dumps(
        want.to_dict(), sort_keys=True)
    for key in (f"{1:016x}", "0", "2", "missing"):
        assert json.dumps(got.request_trace(key), sort_keys=True) == \
            json.dumps(want.request_trace(key), sort_keys=True)
    assert json.dumps(got.to_chrome(), sort_keys=True) == json.dumps(
        want.to_chrome(), sort_keys=True)
    assert got.step_times_us(kind="decode", cat="step") == \
        want.step_times_us(kind="decode", cat="step")
    assert [t.tick for t in got.request_ticks(f"{1:016x}")][:3] == [1, 1, 3]


@pytest.mark.parametrize("pkg", PKGS)
def test_one_writer_many_readers_stay_consistent(pkg):
    obs = pkg.obs
    fl = obs.FlightRecorder(capacity=32, event_capacity=64)
    n_ticks = 600
    stop = threading.Event()
    errors = []

    def writer():
        try:
            for i in range(n_ticks):
                fl.record_tick(
                    "decode" if i % 3 else "prefill", tick=i,
                    request_ids=(i % 8,), trace_ids=(f"t{i % 8}",),
                    wall_us=10.0,
                    spans=(_step_span(obs, "s", i * 10.0, 10.0),))
                if i % 7 == 0:
                    fl.record_event("beat", {"i": i})
                if i == n_ticks // 2:
                    fl.pin(f"t{i % 8}")
        except Exception as e:  # pragma: no cover
            errors.append(e)
        finally:
            stop.set()

    def reader():
        try:
            while not stop.is_set():
                fl.to_dict()
                fl.step_times_us(kind="decode", cat="step")
                fl.request_trace(f"t{len(fl.ticks()) % 8}")
                fl.to_chrome()
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=writer)] + [
        threading.Thread(target=reader) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert len(fl.ticks()) == 32 and fl.dropped_ticks == n_ticks - 32
    seqs = [t.seq for t in fl.ticks()]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)


# -- TestDriftWatchdog -------------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_cadence_and_empty_window_skip(pkg):
    wd = pkg.Watchdog(pkg.engine(), pkg.obs.FlightRecorder(), every=3)
    assert [wd.on_tick() for _ in range(6)] == [False] * 6
    assert wd.ticks == 6 and wd.checks == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_unjoinable_window_advances_watermark(pkg):
    fl = pkg.obs.FlightRecorder()
    wd = pkg.Watchdog(pkg.engine(), fl, every=1)
    fl.record_tick("decode",
                   spans=(_step_span(pkg.obs, "not_a_step", 0, 5.0),))
    assert wd.on_tick() is False and wd.checks == 0
    assert fl.step_times_us(kind="decode", cat="step",
                            after_seq=wd._after_seq)[0] == {}


@pytest.mark.parametrize("pkg", PKGS)
def test_errors_never_escape(pkg):
    class Boom:
        def step_times_us(self, **kw):
            raise RuntimeError("boom")
    wd = pkg.Watchdog(object(), Boom(), every=1)
    assert wd.on_tick() is False and wd.errors == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_every_must_be_positive(pkg):
    with pytest.raises(ValueError):
        pkg.Watchdog(object(), pkg.obs.FlightRecorder(), every=0)


@pytest.mark.parametrize("pkg", PKGS)
def test_on_model_window_does_not_replan(pkg):
    eng = pkg.engine()
    fl = pkg.obs.FlightRecorder()
    reg = pkg.obs.MetricsRegistry()
    wd = pkg.Watchdog(eng, fl, every=1, threshold=0.5, metrics=reg)
    feats = wd._features()
    assert len(feats) >= wd.min_points
    spans = tuple(_step_span(pkg.obs, s, i * 100.0, 2.0 * (r + g) + 5.0)
                  for i, (s, (r, g)) in enumerate(sorted(feats.items())))
    fl.record_tick("decode", spans=spans)
    assert wd.on_tick() is False
    assert wd.checks == 1 and wd.replans == 0 and eng.replans == 0
    assert wd.last_report.rms_rel_drift < 0.5
    assert reg.gauge("drift_watchdog_rms_rel_drift").value == \
        wd.last_report.rms_rel_drift


def _perturbed_window(obs, feats):
    """Alternate steps 8x over the model's shape: high RMS relative drift
    no uniform host slowdown could explain."""
    ts, spans = 0.0, []
    for i, (s, (r, g)) in enumerate(sorted(feats.items())):
        us = (r + g) * (8.0 if i % 2 else 1.0) + 5.0
        spans.append(_step_span(obs, s, ts, us))
        ts += us
    return tuple(spans), ts


def _replan_mid_session(pkg, prompt):
    """Generate 6 tokens, with the watchdog re-planning the engine after
    the second (the reference's acceptance scenario); returns the
    engine, the watchdog and the session's tokens."""
    eng = pkg.engine(metrics=pkg.obs.MetricsRegistry())
    fl = pkg.obs.FlightRecorder()
    wd = pkg.Watchdog(eng, fl, every=2, threshold=0.25, metrics=eng.metrics)
    feats = wd._features()
    assert len(feats) >= wd.min_points
    spans, wall = _perturbed_window(pkg.obs, feats)
    fl.record_tick("decode", spans=spans, wall_us=wall, tick=1)
    sess = eng.start_session(prompt)
    toks = [sess["tok"], eng.session_step(sess)]
    assert wd.on_tick() is False  # tick 1 of 2: off-cadence
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the refit may warn on noise
        assert wd.on_tick() is True
    for _ in range(4):
        toks.append(eng.session_step(sess))
    return eng, wd, toks


def test_replan_mid_session_is_token_exact_against_jax():
    """Perturbed step timings push drift past the threshold; the port's
    watchdog refits and re-plans while a decode session is live.  Its
    report, fit and re-planned decisions equal the JAX watchdog's on the
    same window, and the session's tokens equal both the unperturbed
    port engine's and the JAX engine's (with its own mid-session
    re-plan)."""
    prompt = [3, 5, 7]
    ref = _torch_engine().generate(prompt, max_new_tokens=6).tokens
    teng, twd, ttoks = _replan_mid_session(TORCH, prompt)
    jeng, jwd, jtoks = _replan_mid_session(JAX, prompt)
    assert ttoks == ref == jtoks
    assert twd.replans == teng.replans == 1
    assert teng.metrics.counter("engine_replans_total").value == 1
    assert teng.metrics.counter("drift_watchdog_replans_total").value == 1
    assert twd.last_report.rms_rel_drift > twd.threshold
    assert json.dumps(twd.to_dict(), sort_keys=True) == json.dumps(
        jwd.to_dict(), sort_keys=True)
    assert {d.table: d.layout for d in teng.decode_pipe.layout_plan
            .decisions} == {d.table: d.layout for d in
                            jeng.decode_pipe.layout_plan.decisions}


@pytest.mark.parametrize("pkg", PKGS)
def test_to_dict_shape(pkg):
    wd = pkg.Watchdog(pkg.engine(), pkg.obs.FlightRecorder(), every=5,
                      threshold=0.4, batch=2)
    d = wd.to_dict()
    assert d["every"] == 5 and d["threshold"] == 0.4 and d["batch"] == 2
    assert d["last_report"] is None and d["last_fit"] is None
    assert d["engine_replans"] == 0


def test_watchdog_features_match_jax():
    """The port's watchdog prices the decode pipeline as the reference's
    does (the join key for the observed window), at batch buckets too."""
    teng, jeng = _torch_engine(), _jax_engine()
    for batch in (0, 2, 4):
        assert DriftWatchdog(teng, tobs.FlightRecorder(),
                             batch=batch)._features() == JWatchdog(
            jeng, jobs.FlightRecorder(), batch=batch)._features()
