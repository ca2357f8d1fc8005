"""The port's OpenAI-compatible HTTP front end (``repro_torch.serving.
server``) end to end, held to the JAX package's engine.

Boots a real ``AsyncLLMServer`` over the port's engine on the CPU (own
event-loop thread, ephemeral port, shut down in a ``finally``) and drives
it with the port's asyncio client: concurrent SSE streams through a page
pool small enough to preempt, admission control, error envelopes, the
Prometheus/OpenMetrics scrape with prefix-cache hits, the flight
recorder's ``/debug/*`` endpoints and the drift watchdog.  Decoding is
greedy, so every streamed token sequence must equal the JAX engine's
``generate`` on the same numpy weights exactly.  The reference's
``tests/test_server.py`` cases run here on the port.
"""

import asyncio
import contextlib

import pytest

torch = pytest.importorskip("torch")

from repro.core.llama_graph import LlamaSpec as JSpec  # noqa: E402
from repro.core.llama_graph import init_llama_params  # noqa: E402
from repro.serving.engine import RelationalEngine as JEngine  # noqa: E402
from repro_torch.core.llama_graph import LlamaSpec  # noqa: E402
from repro_torch.obs import MetricsRegistry, TraceRecorder  # noqa: E402
from repro_torch.serving import client  # noqa: E402
from repro_torch.serving.engine import RelationalEngine  # noqa: E402
from repro_torch.serving.kvcache import (PagedKVCache,  # noqa: E402
                                         PagedKVConfig)
from repro_torch.serving.server import (AsyncLLMServer,  # noqa: E402
                                        ServerConfig)

run = asyncio.run

SPEC_ARGS = dict(vocab=64, d_model=32, n_layers=1, n_heads=4, n_kv=2,
                 d_ff=64, rope_theta=10000.0)
SPEC = LlamaSpec(**SPEC_ARGS)
PARAMS = init_llama_params(JSpec(**SPEC_ARGS), seed=3)


@pytest.fixture(scope="module")
def engine():
    return RelationalEngine(SPEC, PARAMS, chunk_size=8, max_len=24,
                            device="cpu")


@pytest.fixture(scope="module")
def traced_engine():
    """The port's engine with a ``TraceRecorder`` (the knob that raised
    before this slice): the server drains its spans into the flight
    ring, so ``/debug/trace`` can attribute ticks."""
    return RelationalEngine(SPEC, PARAMS, chunk_size=8, max_len=24,
                            tracer=TraceRecorder(), device="cpu")


@pytest.fixture(scope="module")
def jax_engine():
    return JEngine(JSpec(**SPEC_ARGS), PARAMS, chunk_size=8, max_len=24)


@contextlib.contextmanager
def _server(engine, n_pages=32, max_batch=3, max_seqs=8, metrics=None,
            **cfg_kw):
    kvcfg = PagedKVConfig(n_layers=SPEC.n_layers, n_kv=SPEC.n_kv,
                          head_dim=SPEC.head_dim, page_size=4,
                          n_pages=n_pages, max_pages_per_seq=6)
    kv = PagedKVCache(kvcfg, max_seqs=max_seqs, device="cpu")
    cfg = ServerConfig(port=0, max_batch=max_batch, **cfg_kw)
    srv = AsyncLLMServer(engine, kv, cfg,
                         metrics=metrics or MetricsRegistry())
    srv.start_in_thread()
    try:
        yield srv
    finally:
        srv.shutdown()


def _stream_all(srv, payloads, path="/v1/completions"):
    async def drive():
        return await asyncio.gather(*(
            client.stream_completion(srv.cfg.host, srv.port, p, path=path)
            for p in payloads))
    return run(drive())


def _get(srv, path, method="GET", body=None):
    return run(client.request(srv.cfg.host, srv.port, method, path, body))


# -- TestStreamingE2E -----------------------------------------------------------


def test_concurrent_streams_with_preemption_match_jax(engine, jax_engine):
    """The acceptance scenario: 8 concurrent SSE streams through ONE
    batched decode loop, the page pool sized so preemption must happen,
    every stream's chunks in order with no gap or duplicate, and its
    tokens equal to the JAX engine's sequential ``generate``."""
    prompts = [[(3 * i + j) % SPEC.vocab for j in range(4 + i % 3)]
               for i in range(8)]
    refs = [jax_engine.generate(p, max_new_tokens=6).tokens
            for p in prompts]
    assert refs == [engine.generate(p, max_new_tokens=6).tokens
                    for p in prompts]
    # every request grows to 3 pages (page_size 4) before it finishes, so
    # 3 lockstep sequences need 9 pages: an 8-page pool must preempt
    with _server(engine, n_pages=8, max_batch=3, max_seqs=8,
                 max_queue_depth=32) as srv:
        results = _stream_all(srv, [{"model": srv.cfg.model_id,
                                     "prompt": p, "max_tokens": 6}
                                    for p in prompts])
        for i, res in enumerate(results):
            assert res.status == 200
            assert res.token_indices == list(range(6))
            assert res.tokens == refs[i]
        assert srv.batcher.stats.decode_steps > 0
        assert srv.decoder.decode_calls == srv.batcher.stats.decode_steps
        assert srv.batcher.stats.preemptions > 0


def test_metrics_scrape_reports_slo_histograms(engine):
    with _server(engine, n_pages=32, max_batch=3, max_tokens_cap=8) as srv:
        _stream_all(srv, [{"prompt": [1 + i, 2, 3], "max_tokens": 4}
                          for i in range(8)])
        _get(srv, "/v1/completions", "POST",
             {"prompt": [1, 2], "max_tokens": 99})
        resp = _get(srv, "/metrics")
        assert resp.status == 200
        assert resp.headers["content-type"].startswith("text/plain")
        text = resp.body.decode()
        assert "serving_ttft_seconds_count" in text
        assert "serving_tpot_seconds_count" in text
        assert 'serving_admission_rejects_total{reason="token_budget"}' \
            in text
        count = [line for line in text.splitlines()
                 if line.startswith("serving_ttft_seconds_count")]
        assert count and float(count[0].split()[-1]) >= 8


def test_shared_prefix_scrape_counts_prefix_hits(engine, jax_engine):
    """Requests over a shared 16-token prefix, admitted through
    ``prefill_ex``: the scrape's ``serving_prefills_total`` splits into
    one cold prefill and ``kind="prefix_hit"`` for the rest, every
    response reports its cached tokens, and the tokens are the JAX
    engine's."""
    shared = [(7 * j + 1) % SPEC.vocab for j in range(16)]
    tails = [[40], [41, 42], [43, 44, 45]]
    with _server(engine, n_pages=64, max_batch=3, max_seqs=4) as srv:
        first = _get(srv, "/v1/completions", "POST",
                     {"prompt": shared + [39], "max_tokens": 3})
        results = [_get(srv, "/v1/completions", "POST",
                        {"prompt": shared + t, "max_tokens": 3})
                   for t in tails]
        text = _get(srv, "/metrics").body.decode()
    lines = {line.split()[0]: float(line.split()[1])
             for line in text.splitlines()
             if line.startswith("serving_prefills_total")}
    assert lines['serving_prefills_total{kind="prefix_hit"}'] == len(tails)
    assert lines['serving_prefills_total{kind="cold"}'] == 1
    assert first.json()["usage"].get("prompt_tokens_details", {}).get(
        "cached_tokens", 0) == 0
    for t, res in zip(tails, results):
        data = res.json()
        assert data["usage"]["prompt_tokens_details"]["cached_tokens"] == 16
        assert data["choices"][0]["token_ids"] == jax_engine.generate(
            shared + t, max_new_tokens=3).tokens


def test_saturation_yields_429_with_retry_after(engine):
    with _server(engine, max_batch=1, max_seqs=1, max_queue_depth=1,
                 retry_after_s=2.0) as srv:
        results = _stream_all(srv, [{"prompt": [5, 9, 2, 7],
                                     "max_tokens": 8}] * 6)
        ok = [r for r in results if r.status == 200]
        rejected = [r for r in results if r.status == 429]
        assert ok and rejected
        for r in rejected:
            assert r.headers.get("retry-after") == "2"
            assert r.error["error"]["code"] == "saturated"
        for r in ok:
            assert r.token_indices == list(range(8))
        assert 'serving_admission_rejects_total{reason="queue_full"}' \
            in _get(srv, "/metrics").body.decode()


# -- TestHttpApi ----------------------------------------------------------------


def test_models_endpoint(engine):
    with _server(engine) as srv:
        resp = _get(srv, "/v1/models")
        assert resp.status == 200
        data = resp.json()
        assert data["object"] == "list"
        assert data["data"][0]["id"] == srv.cfg.model_id


def test_blocking_completion_matches_jax(engine, jax_engine):
    prompt = [5, 9, 2, 7]
    ref = jax_engine.generate(prompt, max_new_tokens=5).tokens
    with _server(engine) as srv:
        resp = _get(srv, "/v1/completions", "POST",
                    {"prompt": prompt, "max_tokens": 5, "stream": False})
        assert resp.status == 200
        data = resp.json()
        assert data["object"] == "text_completion"
        assert data["choices"][0]["token_ids"] == ref
        assert data["choices"][0]["finish_reason"] == "length"
        assert data["usage"]["completion_tokens"] == 5
        assert data["usage"]["prompt_tokens"] == len(prompt)


def test_chat_completions_stream_matches_jax(engine, jax_engine):
    with _server(engine) as srv:
        res, = _stream_all(srv, [{"messages": [{"role": "user",
                                                "content": "hi"}],
                                  "max_tokens": 4}],
                           path="/v1/chat/completions")
        assert res.status == 200
        assert res.token_indices == list(range(4))
        assert res.events[0]["object"] == "chat.completion.chunk"
        assert all("delta" in e["choices"][0] for e in res.events)
        prompt = [ord(c) % SPEC.vocab for c in "hi"]
        assert res.tokens == jax_engine.generate(prompt,
                                                 max_new_tokens=4).tokens


@pytest.mark.parametrize("body,code", [
    ({"prompt": [1, 2], "max_tokens": 9}, "max_tokens_cap"),
    ({"prompt": list(range(20)), "max_tokens": 8}, "context_length"),
    ({"prompt": [], "max_tokens": 4}, None),
], ids=["max_tokens_cap", "context_length", "bad_prompt"])
def test_bad_requests_are_400(engine, body, code):
    with _server(engine, max_tokens_cap=8) as srv:
        resp = _get(srv, "/v1/completions", "POST", body)
        assert resp.status == 400
        if code is not None:
            assert resp.json()["error"]["code"] == code


def test_unknown_route_is_404_and_healthz(engine):
    with _server(engine) as srv:
        resp = _get(srv, "/v1/nope")
        assert resp.status == 404
        assert resp.json()["error"]["code"] == "not_found"
        health = _get(srv, "/healthz")
        assert health.status == 200 and health.json()["status"] == "ok"


# -- TestDebugEndpoints -------------------------------------------------------------


async def _raw_get(host, port, path, extra_headers=""):
    """GET with caller-chosen headers (the client pins its own)."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write((f"GET {path} HTTP/1.1\r\nHost: localhost\r\n"
                      f"{extra_headers}Connection: close\r\n\r\n").encode())
        await writer.drain()
        status = int((await reader.readline()).split()[1])
        headers = {}
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode().partition(":")
            headers[k.strip().lower()] = v.strip()
        return status, headers, await reader.read()
    finally:
        writer.close()
        with contextlib.suppress(ConnectionError):
            await writer.wait_closed()


def test_trace_id_rides_every_response_shape(engine):
    with _server(engine) as srv:
        stream, = _stream_all(srv, [{"prompt": [4, 2], "max_tokens": 3}])
        assert stream.status == 200
        tid = stream.trace_id
        assert tid and len(tid) == 16 and int(tid, 16) >= 0
        assert {e["trace_id"] for e in stream.events} == {tid}
        blocking = _get(srv, "/v1/completions", "POST",
                        {"prompt": [4, 2], "max_tokens": 3,
                         "stream": False})
        assert len(blocking.json()["trace_id"]) == 16
        assert blocking.json()["trace_id"] != tid


def test_debug_flight_and_trace_reconstruction(traced_engine, jax_engine):
    """A traced engine behind the server: ``/debug/flight`` retains
    admission, prefill and decode ticks, and ``/debug/trace/{id}``
    rebuilds one request end to end with its ``cat="step"`` and
    ``cat="op"`` spans (the pipeline steps of the reference, by name),
    by trace id or by request id; the streamed tokens are the JAX
    engine's."""
    prompt = [7, 1, 9]
    with _server(traced_engine) as srv:
        stream, = _stream_all(srv, [{"prompt": prompt, "max_tokens": 4}])
        assert stream.status == 200
        assert stream.tokens == jax_engine.generate(
            prompt, max_new_tokens=4).tokens
        flight = _get(srv, "/debug/flight").json()
        assert flight["retained_ticks"] > 0
        assert {"admission", "prefill", "decode"} <= {
            t["kind"] for t in flight["ticks"]}
        trace = _get(srv, f"/debug/trace/{stream.trace_id}")
        assert trace.status == 200
        data = trace.json()
        assert data["trace_id"] == stream.trace_id
        kinds = [t["kind"] for t in data["ticks"]]
        assert kinds[0] == "admission"
        assert "prefill" in kinds and "decode" in kinds
        assert data["wall_us"] > 0 and data["coverage"] > 0.5
        cats = {e["cat"] for e in data["traceEvents"]}
        assert {"step", "op", "decoder"} <= cats
        steps = {e["name"] for e in data["traceEvents"]
                 if e["cat"] == "step"}
        assert {s.name for s in traced_engine._prefill_pipe(
            len(prompt)).steps} <= steps
        rid = data["request_id"]
        assert _get(srv, f"/debug/trace/{rid}").json()["trace_id"] == \
            stream.trace_id


def test_debug_trace_unknown_id_is_404(engine):
    with _server(engine) as srv:
        resp = _get(srv, "/debug/trace/deadbeefdeadbeef")
        assert resp.status == 404
        assert resp.json()["error"]["code"] == "trace_not_found"


def test_debug_drift_disabled_and_enabled(engine):
    with _server(engine) as srv:
        off = _get(srv, "/debug/drift").json()
        assert off["enabled"] is False
    with _server(engine, drift_every=500) as srv:
        assert srv.watchdog is not None
        on = _get(srv, "/debug/drift").json()
        assert on["every"] == 500 and on["replans"] == 0
        assert on["engine_replans"] == engine.replans


def test_watchdog_checks_served_ticks(jax_engine):
    """A traced server with the watchdog every 2 ticks: the watchdog
    joins the served decode ticks' step spans against the cost model
    (``checks`` > 0 and a report on ``/debug/drift``), and the tokens
    stay the JAX engine's whether or not it re-planned."""
    eng = RelationalEngine(SPEC, PARAMS, chunk_size=8, max_len=24,
                           tracer=TraceRecorder(), device="cpu")
    prompts = [[2, 4, 6], [1, 3, 5, 7]]
    with _server(eng, drift_every=2, drift_threshold=0.5) as srv:
        results = _stream_all(srv, [{"prompt": p, "max_tokens": 6}
                                    for p in prompts])
        drift = _get(srv, "/debug/drift").json()
    # a stream ends inside its last tick, before that tick's watchdog
    # check, and a re-plan bumps the engine's count before the
    # watchdog's: the live read above can fall between them, so the
    # counts it serves are compared once the server (and its scheduler
    # thread) stopped, on the dict the endpoint serialises
    final = srv.watchdog.to_dict()
    assert drift["ticks"] > 0 and drift["checks"] > 0
    assert drift["last_report"]["steps"]
    assert drift["replans"] <= final["replans"]
    assert final["engine_replans"] == eng.replans == final["replans"]
    for p, res in zip(prompts, results):
        assert res.tokens == jax_engine.generate(p, max_new_tokens=6).tokens


def test_metrics_content_negotiation(engine):
    with _server(engine) as srv:
        _stream_all(srv, [{"prompt": [1, 2], "max_tokens": 2}])
        plain = _get(srv, "/metrics")
        assert plain.headers["content-type"].startswith("text/plain")
        assert "# EOF" not in plain.body.decode()

        async def negotiate():
            return (await _raw_get(srv.cfg.host, srv.port,
                                   "/metrics?format=openmetrics"),
                    await _raw_get(srv.cfg.host, srv.port, "/metrics",
                                   "Accept: application/openmetrics-text; "
                                   "version=1.0.0\r\n"))
        for status, headers, body in run(negotiate()):
            assert status == 200
            assert headers["content-type"].startswith(
                "application/openmetrics-text")
            text = body.decode()
            assert text.endswith("# EOF\n")
            assert "serving_ttft_seconds_bucket" in text
            assert '# {trace_id="' in text


def test_admin_shutdown_stops_the_server(engine):
    kvcfg = PagedKVConfig(n_layers=SPEC.n_layers, n_kv=SPEC.n_kv,
                          head_dim=SPEC.head_dim, page_size=4, n_pages=16,
                          max_pages_per_seq=6)
    srv = AsyncLLMServer(engine, PagedKVCache(kvcfg, max_seqs=2,
                                              device="cpu"),
                         ServerConfig(port=0, max_batch=2))
    thread = srv.start_in_thread()
    try:
        assert _get(srv, "/admin/shutdown", "POST").json() == {
            "status": "stopping"}
        thread.join(timeout=30)
        assert not thread.is_alive()
        assert not srv._sched_thread.is_alive()
    finally:
        if thread.is_alive():  # the loop is closed once it has stopped
            srv.shutdown()


# -- a request that can never fit the page pool ------------------------------


def test_request_that_can_never_fit_is_failed_where_jax_spins():
    """The reference's batcher waits forever on a queued request whose
    context needs more pages than the whole pool: one ``tick()`` admits
    nothing and still reports work (so a scheduler loop spins; called once
    here, never in a loop).  The port's fails it through ``on_done`` with
    ``error="context_exceeds_pool"`` and serves the request behind it."""
    from repro.serving.kvcache import PagedKVCache as JKV
    from repro.serving.kvcache import PagedKVConfig as JKVConfig
    from repro.serving.scheduler import ContinuousBatcher as JBatcher
    from repro.serving.scheduler import Request as JRequest
    from repro_torch.serving.scheduler import ContinuousBatcher, Request

    kw = dict(n_layers=1, n_kv=2, head_dim=8, page_size=4, n_pages=4,
              max_pages_per_seq=8)
    big = list(range(20))  # ceil(24 / 4) + 1 = 7 pages > 4

    def prefill(req, seq_id):
        return 1

    def decode(seq_ids, last):
        return [1] * len(seq_ids)

    jb = JBatcher(JKV(JKVConfig(**kw), max_seqs=2), prefill, decode,
                  max_batch=1)
    jb.submit(JRequest(rid=0, prompt=big, max_new_tokens=4))
    assert jb.tick() is True
    assert not jb.active and len(jb.queue) == 1

    done = []
    b = ContinuousBatcher(PagedKVCache(PagedKVConfig(**kw), max_seqs=2,
                                       device="cpu"),
                          prefill, decode, max_batch=1, on_done=done.append)
    b.submit(Request(rid=0, prompt=big, max_new_tokens=4))
    b.submit(Request(rid=1, prompt=[1, 2, 3], max_new_tokens=2))
    finished = b.run(max_ticks=10)
    assert [(r.rid, r.error) for r in done] == [(0, "context_exceeds_pool"),
                                                (1, None)]
    assert [r.rid for r in finished] == [1]
    assert finished[0].generated == [1, 1]
    assert not b.queue and not b.active


def test_request_larger_than_the_pool_is_400(engine):
    """The server checks the pool at admission: prompt + max_tokens that
    need more pages than the pool holds are a 400, not a queued request."""
    with _server(engine, n_pages=4, max_tokens_cap=8) as srv:
        resp = _get(srv, "/v1/completions", "POST",
                    {"prompt": list(range(10)), "max_tokens": 8})
        assert resp.status == 400
        assert resp.json()["error"]["code"] == "context_exceeds_pool"
        ok = _get(srv, "/v1/completions", "POST",
                  {"prompt": [1, 2, 3], "max_tokens": 2})
        assert ok.status == 200
