"""The port's tracer as a measurement of the serving loop (no JAX here):
spans on the profiler's clock with their thread, retained in a form the
cyclic collector does not walk, step spans that never wait for the card
and take the card's time from CUDA events read after the call's host
read, one pager span over each miss, ``device_wait`` spans around the
host's reads of the logits, ``gc`` spans while a server has a tracer,
and a scheduler that drains every span into the flight ring.
"""

import gc
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.llama_graph import (LlamaSpec,  # noqa: E402
                                          init_llama_params)
from repro_torch.obs import (FlightRecorder, MetricsRegistry,  # noqa: E402
                             TraceContext, TraceRecorder, activate)
from repro_torch.obs.trace import (TID, GcSpans, SpanEvent,  # noqa: E402
                                   record_arg)
from repro_torch.serving.engine import RelationalEngine  # noqa: E402
from repro_torch.serving.kvcache import (PagedKVCache,  # noqa: E402
                                         PagedKVConfig)
from repro_torch.serving.pager import WeightPager  # noqa: E402
from repro_torch.serving.server import (AsyncLLMServer,  # noqa: E402
                                        ServerConfig)

SPEC = LlamaSpec(vocab=64, d_model=32, n_layers=1, n_heads=4, n_kv=2,
                 d_ff=64, rope_theta=10000.0)
PARAMS = init_llama_params(SPEC, seed=3)


def _engine(**kw):
    return RelationalEngine(SPEC, PARAMS, chunk_size=8, max_len=24,
                            device="cpu", **kw)


class _Event:
    """A stand-in for a CUDA timing event: ``record`` stamps a fake
    stream's clock, ``elapsed_time`` gives ms between two stamps."""

    made = 0

    def __init__(self):
        _Event.made += 1
        self.t = None

    def record(self, stream):
        self.t = stream.now_ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


class _Stream:
    """A stand-in for a CUDA stream: it has no ``synchronize``, so a span
    that waited on it would raise."""

    def __init__(self):
        self.now_ms = 0.0


def _fake_events(tracer, n):
    tracer._pool = [_Event() for _ in range(n)]


def test_span_times_are_on_the_profilers_clock():
    """``epoch_ns + ts_us * 1000`` places a span on ``time.time_ns``,
    the clock ``torch.profiler`` stamps the card's events on; the flight
    recorder built for the tracer stamps its ticks on the same clock."""
    tracer = TraceRecorder()
    before = time.time_ns()
    with tracer.span("outer", cat="step"):
        time.sleep(0.002)
    after = time.time_ns()
    rec, = tracer.drain_records()
    start = tracer.epoch_ns + rec[2] * 1e3
    end = start + rec[3] * 1e3
    assert before - 1e3 <= start <= end <= after + 1e3
    assert end - start >= 2e6
    flight = FlightRecorder.for_tracer(tracer)
    now = tracer.epoch_ns + flight.now_us() * 1e3
    assert abs(now - time.time_ns()) < 1e6


def test_each_span_records_its_thread():
    tracer = TraceRecorder()
    with tracer.span("main", cat="step"):
        pass

    def other():
        tracer.add_span("prefetch", "pager", 0.0, 1.0, depth=1)
    t = threading.Thread(target=other)
    t.start()
    t.join()
    tids = {r[0]: r[TID] for r in tracer.drain_records()}
    assert tids["main"] == threading.get_ident()
    assert tids["prefetch"] == t.ident != tids["main"]


def test_retained_spans_are_not_tracked_by_the_collector():
    """A served tick's spans in the flight ring (context ids, step
    provenance lists and all) are flat tuples of atomic values: once the
    collector has passed over them, none is tracked, and the args read
    back as they were given."""
    eng = _engine(tracer=TraceRecorder())
    dec = eng.batched_decoder(2)
    flight = FlightRecorder.for_tracer(eng.tracer)
    ctx = TraceContext(request_ids=(1, 2), trace_ids=("a1", "b2"),
                       phase="decode", tick=4)
    last = [dec.prefill([1, 2, 3], 0), dec.prefill([9, 8], 1)]
    eng.tracer.clear()
    with activate(ctx):
        dec.decode([0, 1], last)
    tick = flight.record_tick("decode", spans=eng.tracer.drain_records())
    for _ in range(3):  # a tuple made before its items: one pass each
        gc.collect()
    assert len(tick.records) > 20
    assert not gc.is_tracked(tick.records)
    for rec in tick.records:
        assert type(rec) is tuple and not gc.is_tracked(rec)
    steps = [s for s in tick.spans if s.cat == "step"]
    assert steps and steps[0].args["rids"] == [1, 2]
    assert steps[0].args["trace_ids"] == ["a1", "b2"]
    assert isinstance(steps[0].args["ops"], list)
    assert SpanEvent.from_record(steps[0].to_record()) == steps[0]


def test_step_spans_take_the_cards_time_from_events_read_later():
    """A step span records a pair of events on the stream and waits for
    nothing; ``resolve_device`` (after the host read) stores their time
    as ``device_us``, which the recorder's, the flight tick's and the
    flight recorder's step times read in place of the host's duration.
    The events go back to the pool."""
    tracer = TraceRecorder()
    _Event.made = 0
    _fake_events(tracer, 4)
    stream = _Stream()
    for name, ms in (("a", 3.0), ("b", 5.0)):
        with tracer.device_span(name, "step", stream, kind="bind"):
            stream.now_ms += ms
        tracer.add_span("pager_prefetch:w", "pager", 0.0, 1.0, depth=1)
    assert [e.args for e in tracer.events if e.cat == "step"] == [
        {"kind": "bind"}, {"kind": "bind"}]
    tracer.resolve_device()
    assert tracer.step_times_us() == {"a": 3000.0, "b": 5000.0}
    assert [e.args["device_us"] for e in tracer.events
            if e.cat == "step"] == [3000.0, 5000.0]
    assert len(tracer._pool) == 4 and _Event.made == 4
    with tracer.device_span("a", "step", stream):
        stream.now_ms += 1.0
    tracer.resolve_device()
    assert _Event.made == 4
    flight = FlightRecorder.for_tracer(tracer)
    tick = flight.record_tick("decode", spans=tracer.drain_records())
    assert tick.step_times_us() == {"a": 4000.0, "b": 5000.0}
    assert flight.step_times_us()[0] == {"a": 4000.0, "b": 5000.0}


def test_unread_events_are_dropped_with_their_spans():
    """A span drained before its events were read keeps its host
    duration; its events return to the pool."""
    tracer = TraceRecorder()
    _fake_events(tracer, 2)
    with tracer.device_span("a", "step", _Stream()):
        pass
    rec, = tracer.drain_records()
    tracer.resolve_device()
    assert record_arg(rec, "device_us") is None
    assert len(tracer._pool) == 2 and not tracer._pending


def test_host_reads_of_the_logits_are_device_wait_spans():
    """A prefill's and a batched decode's host read of the logits each
    run under a ``device_wait`` span (``cat="decoder"``): top level after
    a prefill's steps, inside ``logits_argmax`` in a decode."""
    tracer = TraceRecorder()
    eng = _engine(tracer=tracer)
    dec = eng.batched_decoder(2)
    last = [dec.prefill([1, 2, 3], 0), dec.prefill([9, 8], 1)]
    spans = tracer.events
    waits = [e for e in spans if e.name == "device_wait"]
    assert len(waits) == 2 and all(e.depth == 0 and e.cat == "decoder"
                                   for e in waits)
    tracer.clear()
    dec.decode([0, 1], last)
    spans = tracer.events
    wait, = [e for e in spans if e.name == "device_wait"]
    outer, = [e for e in spans if e.name == "logits_argmax"]
    assert wait.depth == outer.depth + 1
    assert outer.ts_us <= wait.ts_us <= wait.ts_us + wait.dur_us <= \
        outer.ts_us + outer.dur_us


def test_one_pager_span_a_miss_covers_the_whole_get():
    """Every miss gives one ``pager_fetch:`` span (as many as the misses
    counted), from the ``get``'s entry past its evictions; hits and
    prefetch hits give none."""
    rng = np.random.default_rng(0)
    tracer = TraceRecorder()
    pager = WeightPager(800, policy="pin", tracer=tracer, device="cpu")
    for i in range(5):
        pager.add(f"w{i}", rng.standard_normal((4, 8 * (i + 1))).astype(
            np.float32))
    evictions = []
    inner = pager._evict_until
    me = threading.get_ident()

    def timed(need):
        t0 = tracer._now_us()
        n = pager.stats.evictions
        inner(need)
        if pager.stats.evictions > n and threading.get_ident() == me:
            evictions.append((t0, tracer._now_us()))
    pager._evict_until = timed
    misses = pager.stats.misses
    for name in ("w0", "w1", "w0", "w4", "w2", "w4", "w3"):
        pager.get(name)
    pager.prefetch(["w1"]).join(timeout=30)
    pager.get("w1")
    fetches = [e for e in tracer.events
               if e.name.startswith("pager_fetch:")]
    assert len(fetches) == pager.stats.misses - misses > 0
    assert pager.stats.hits > 0 and pager.stats.prefetch_hits == 1
    assert evictions
    for a, b in evictions:
        assert any(e.ts_us <= a and b <= e.ts_us + e.dur_us
                   for e in fetches)
    assert all(e.cat == "pager" and e.depth == 1 and e.args["bytes"] > 0
               for e in fetches)


@pytest.mark.parametrize("traced", [True, False])
def test_gc_spans_while_a_server_has_a_tracer(traced):
    """A server with a tracer records every collection as a ``gc`` span
    (``cat="gc"``, its generation in the args) from start to shutdown,
    and leaves ``gc.callbacks`` as it found them; without a tracer it
    hooks nothing."""
    tracer = TraceRecorder() if traced else None
    eng = _engine(tracer=tracer)
    hooks = list(gc.callbacks)
    kv = PagedKVCache(PagedKVConfig(
        n_layers=1, n_kv=2, head_dim=8, page_size=4, n_pages=16,
        max_pages_per_seq=6), max_seqs=2, device="cpu")
    srv = AsyncLLMServer(eng, kv, ServerConfig(port=0, max_batch=2),
                         metrics=MetricsRegistry())
    srv.start_in_thread()
    try:
        assert any(isinstance(h, GcSpans) for h in gc.callbacks) == traced
        gc.collect()
        if traced:
            spans = [e for e in tracer.events if e.cat == "gc"]
            assert spans and spans[-1].name == "gc"
            assert spans[-1].args["generation"] == 2
            assert spans[-1].dur_us > 0
    finally:
        srv.shutdown()
    assert gc.callbacks == hooks
    if traced:
        n = len(tracer.events)
        gc.collect()
        assert len(tracer.events) == n


def test_gc_span_depth_follows_the_open_spans():
    tracer = TraceRecorder()
    hook = GcSpans(tracer).install()
    try:
        gc.collect()
        with tracer.span("step", cat="step"):
            gc.collect()
    finally:
        hook.remove()
    depths = [e.depth for e in tracer.events if e.cat == "gc"]
    assert depths[0] == 0 and depths[-1] == 1
    assert hook not in gc.callbacks


def test_scheduler_drains_every_span_into_the_ring():
    """A span another thread records between two calls lands in the next
    call's flight record, so the tracer holds nothing after a tick; a
    tick starts where its call started, on the flight recorder's
    clock."""
    from repro_torch.serving.scheduler import ContinuousBatcher, Request
    tracer = TraceRecorder()
    eng = _engine(tracer=tracer)
    dec = eng.batched_decoder(2)
    kv = PagedKVCache(PagedKVConfig(
        n_layers=1, n_kv=2, head_dim=8, page_size=4, n_pages=16,
        max_pages_per_seq=6), max_seqs=2, device="cpu")
    flight = FlightRecorder.for_tracer(tracer)
    batcher = ContinuousBatcher(
        kv, lambda r, s: dec.prefill_ex(r.context, s), dec.decode,
        max_batch=2, release_fn=dec.free, tracer=tracer, flight=flight)
    batcher.submit(Request(rid=0, prompt=[1, 2, 3], max_new_tokens=3))
    t_call = flight.now_us()
    batcher.tick()
    assert len(tracer.events) == 0
    t = threading.Thread(target=lambda: tracer.add_span(
        "pager_prefetch:w", "pager", flight.now_us(), 1.0, depth=1))
    t.start()
    t.join()
    batcher.tick()
    assert len(tracer.events) == 0
    ticks = flight.ticks()
    assert flight.next_seq == ticks[-1].seq + 1 == 3
    assert [k.kind for k in ticks] == ["prefill", "decode", "decode"]
    assert ticks[0].ts_us >= t_call
    assert "pager_prefetch:w" in {s.name for s in ticks[-1].spans}


def test_admission_is_in_the_ring_before_the_scheduler_sees_it(
        monkeypatch):
    """The admission record goes in before the request reaches the
    scheduler: however late the HTTP thread runs after handing it over,
    a request's trace starts with its admission."""
    from repro_torch.serving import client
    import asyncio
    slow = FlightRecorder.record_admission

    def late(self, *a, **kw):
        time.sleep(0.3)
        return slow(self, *a, **kw)
    monkeypatch.setattr(FlightRecorder, "record_admission", late)
    eng = _engine(tracer=TraceRecorder())
    kv = PagedKVCache(PagedKVConfig(
        n_layers=1, n_kv=2, head_dim=8, page_size=4, n_pages=16,
        max_pages_per_seq=6), max_seqs=2, device="cpu")
    srv = AsyncLLMServer(eng, kv, ServerConfig(port=0, max_batch=2))
    srv.start_in_thread()
    try:
        res = asyncio.run(client.stream_completion(
            srv.cfg.host, srv.port, {"prompt": [7, 1, 9], "max_tokens": 2}))
        kinds = [t.kind for t in srv.flight.request_ticks(res.trace_id)]
    finally:
        srv.shutdown()
    assert kinds[:2] == ["admission", "prefill"]
