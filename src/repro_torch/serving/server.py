"""OpenAI-compatible async HTTP front end over the ContinuousBatcher.

One :class:`AsyncLLMServer` owns one ``RelationalEngine`` +
``BatchedDecoder`` + ``ContinuousBatcher``.  The batcher runs in a
dedicated scheduler thread (decode ticks on the card never block the
event loop); tokens cross back into asyncio through per-request queues fed
by the scheduler's ``on_token``/``on_done`` hooks via
``loop.call_soon_threadsafe`` — the non-blocking handoff that lets SSE
chunks leave as each batched decode tick produces them.

Endpoints (stdlib asyncio streams — no HTTP framework):

  ``POST /v1/completions``        — OpenAI completions; ``stream: true``
                                    emits SSE chunks per decode tick
  ``POST /v1/chat/completions``   — chat schema over the same path
  ``GET  /v1/models``             — the single served model
  ``GET  /metrics``               — Prometheus text exposition of the
                                    shared ``obs.metrics`` registry;
                                    OpenMetrics (with trace-id exemplars)
                                    via Accept negotiation or
                                    ``?format=openmetrics``
  ``GET  /healthz``               — liveness + queue depth
  ``GET  /debug/flight``          — flight-recorder dump: the last N
                                    prefill/decode ticks + event log
  ``GET  /debug/trace/{id}``      — one request's end-to-end Chrome
                                    trace (id = trace_id or request id)
  ``GET  /debug/drift``           — drift watchdog state + last report
  ``POST /admin/shutdown``        — graceful stop (used by CI)

Every admitted request is assigned a ``trace_id`` (returned on
responses and SSE chunks as an extension field); the scheduler runs its
prefill/decode work under that request-scoped :class:`TraceContext`, so
``/debug/trace/{trace_id}`` reconstructs admission → prefill → decode
ticks → DB operators end to end.  The optional drift watchdog
(``drift_every > 0``) periodically checks observed step timings against
the cost model and re-plans the engine mid-flight when they diverge.

Admission control: a bounded waiting queue (HTTP 429 + ``Retry-After``
when full), per-request token budget caps and a context-length cap
(HTTP 400).  Each admitted request carries TTFT/TPOT SLOs (server
defaults, per-request ``*_slo_ms`` overrides) recorded as
violation counters and fed to the scheduler's preemption victim choice —
requests already past deadline are evicted first.

Streaming-side dedupe guard: each request tracks how many tokens were
delivered; the emit hook only forwards ``generated[delivered:]``, so even
a scheduler that replayed tokens (the pre-fix preemption behaviour)
could not stream a duplicate.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import json
import threading
import time
from collections import deque
from typing import Deque, Dict, Optional, Tuple

import torch

from repro_torch.obs.context import new_trace_id
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.log import set_flight_recorder
from repro_torch.obs.trace import GcSpans
from repro_torch.obs.metrics import (OPENMETRICS_CONTENT_TYPE,
                                     PROMETHEUS_CONTENT_TYPE)
from repro_torch.serving import api
from repro_torch.serving.scheduler import (ContinuousBatcher, Request,
                                          pages_needed)
from repro_torch.serving.watchdog import DriftWatchdog


@dataclasses.dataclass
class ServerConfig:
    host: str = "127.0.0.1"
    port: int = 8008                  # 0 = ephemeral (tests)
    model_id: str = "transql-tiny"
    max_batch: int = 4
    max_queue_depth: int = 32         # waiting requests before 429
    max_tokens_cap: int = 64          # per-request generation budget cap
    retry_after_s: float = 1.0        # hint sent with 429
    ttft_slo_s: Optional[float] = None   # default SLOs (None = unset)
    tpot_slo_s: Optional[float] = None
    idle_wait_s: float = 0.02         # scheduler-thread sleep when drained
    flight_capacity: int = 256        # ticks retained by the flight ring
    flight_events: int = 1024         # log events retained alongside
    drift_every: int = 0              # watchdog cadence in ticks (0 = off)
    drift_threshold: float = 0.5      # RMS relative drift that re-plans


@dataclasses.dataclass
class _Stream:
    """Per-request bridge from the scheduler thread to one HTTP response."""

    req: Request
    queue: "asyncio.Queue[Tuple[str, Optional[int]]]"
    delivered: int = 0  # tokens already forwarded (dedupe guard)


class AsyncLLMServer:
    """Serve one engine's batched decode loop over HTTP."""

    def __init__(self, engine, kv, cfg: Optional[ServerConfig] = None,
                 metrics=None, tracer=None):
        self.engine = engine
        self.kv = kv
        self.cfg = cfg or ServerConfig()
        self.metrics = metrics if metrics is not None else engine.metrics
        self.tracer = tracer if tracer is not None else engine.tracer
        self.tokenizer = api.ToyTokenizer(engine.spec.vocab)
        self.decoder = engine.batched_decoder(max_seqs=kv.max_seqs)

        # flight recorder: shares the tracer's epoch so spans, events and
        # tick records interleave on one timeline; log_event() output is
        # forwarded into its event ring
        self.flight = (FlightRecorder.for_tracer(
                           self.tracer, capacity=self.cfg.flight_capacity,
                           event_capacity=self.cfg.flight_events)
                       if self.tracer is not None
                       else FlightRecorder(
                           capacity=self.cfg.flight_capacity,
                           event_capacity=self.cfg.flight_events))
        set_flight_recorder(self.flight)
        self.watchdog = (DriftWatchdog(
                             engine, self.flight,
                             every=self.cfg.drift_every,
                             threshold=self.cfg.drift_threshold,
                             batch=engine._decode_bucket(
                                 min(self.cfg.max_batch, kv.max_seqs)),
                             metrics=self.metrics)
                         if self.cfg.drift_every > 0 else None)

        def prefill(req, seq_id):
            # req.context (prompt + preserved generated prefix), NOT
            # req.prompt: a preempted request resumes, it does not replay.
            # prefill_ex returns (token, cached_tokens): the scheduler
            # splits its prefill counters on the reuse and records
            # cached_tokens on the request for the usage wire field
            ctx = req.context
            kv.ensure_capacity(seq_id, len(ctx))
            return self.decoder.prefill_ex(ctx, seq_id)

        self.batcher = ContinuousBatcher(
            kv, prefill, self.decoder.decode,
            max_batch=min(self.cfg.max_batch, kv.max_seqs),
            release_fn=self.decoder.free, metrics=self.metrics,
            on_token=self._on_token, on_done=self._on_done,
            tracer=self.tracer, flight=self.flight,
            watchdog=self.watchdog)

        self._streams: Dict[int, _Stream] = {}
        self._pending: Deque[Request] = deque()
        self._cond = threading.Condition()
        self._next_rid = 0
        self._stop = False
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._http: Optional[asyncio.base_events.Server] = None
        self._sched_thread: Optional[threading.Thread] = None
        self._shutdown_ev: Optional[asyncio.Event] = None
        self._gc_spans: Optional[GcSpans] = None
        self.port: Optional[int] = None

    # -- scheduler thread ----------------------------------------------------

    def _scheduler_loop(self) -> None:
        """The batcher's loop on its own thread.  The engine was built on
        another thread: on a CUDA engine the loop makes the engine's card
        current here, and every tick runs on this thread's current stream,
        on which the step spans record their events and which the pager's
        ``record_stream`` names."""
        dev = getattr(self.engine, "device", None)
        with (torch.cuda.device(dev) if dev is not None
              and dev.type == "cuda" else contextlib.nullcontext()):
            self._run_batcher()

    def _run_batcher(self) -> None:
        while True:
            with self._cond:
                while self._pending:
                    self.batcher.submit(self._pending.popleft())
                if self._stop:
                    return
            more = self.batcher.tick()
            if not more:
                with self._cond:
                    if not self._pending and not self._stop:
                        self._cond.wait(timeout=self.cfg.idle_wait_s)

    def _on_token(self, req: Request, tok: int) -> None:
        """Scheduler-thread hook: forward newly generated tokens.

        Forwarding ``generated[delivered:]`` (not the callback's token)
        is the streaming-side dedupe guard — a replayed token index can
        never be sent twice, whatever the scheduler did."""
        stream = self._streams.get(req.rid)
        if stream is None or self._loop is None:
            return
        new = req.generated[stream.delivered:]
        stream.delivered = len(req.generated)
        for t in new:
            self._loop.call_soon_threadsafe(
                stream.queue.put_nowait, ("token", int(t)))

    def _on_done(self, req: Request) -> None:
        stream = self._streams.get(req.rid)
        if stream is None or self._loop is None:
            return
        self._loop.call_soon_threadsafe(
            stream.queue.put_nowait, ("done", None))

    # -- admission -----------------------------------------------------------

    def _queue_depth(self) -> int:
        return len(self._pending) + len(self.batcher.queue)

    def _reject(self, reason: str) -> None:
        if self.metrics is not None:
            self.metrics.counter(
                "serving_admission_rejects_total",
                "requests rejected at admission", reason=reason).inc()

    def _admit_request(self, parsed: api.CompletionRequest) -> _Stream:
        cfg = self.cfg
        t0_admit = time.perf_counter()
        if parsed.max_tokens > cfg.max_tokens_cap:
            self._reject("token_budget")
            raise api.ApiError(
                400, f"max_tokens ({parsed.max_tokens}) exceeds this "
                     f"server's cap ({cfg.max_tokens_cap})",
                code="max_tokens_cap")
        if len(parsed.prompt) + parsed.max_tokens > self.engine.max_len:
            self._reject("context_length")
            raise api.ApiError(
                400, f"prompt ({len(parsed.prompt)} tokens) + max_tokens "
                     f"({parsed.max_tokens}) exceeds the model context "
                     f"({self.engine.max_len})", code="context_length")
        kv_cfg = self.batcher.kv.cfg
        need = pages_needed(len(parsed.prompt) + parsed.max_tokens,
                            kv_cfg.page_size)
        if need > kv_cfg.n_pages:
            self._reject("context_exceeds_pool")
            raise api.ApiError(
                400, f"prompt ({len(parsed.prompt)} tokens) + max_tokens "
                     f"({parsed.max_tokens}) needs {need} KV pages, more "
                     f"than the whole pool ({kv_cfg.n_pages})",
                code="context_exceeds_pool")
        if self._queue_depth() >= cfg.max_queue_depth:
            self._reject("queue_full")
            raise api.ApiError(
                429, "serving queue is full, retry later",
                code="saturated", retry_after_s=cfg.retry_after_s)
        with self._cond:
            rid = self._next_rid
            self._next_rid += 1
            req = Request(
                rid=rid, prompt=list(parsed.prompt),
                max_new_tokens=parsed.max_tokens,
                # the end-to-end trace id is minted HERE, at HTTP
                # admission — the earliest point the request exists —
                # and returned on the response as an extension field
                trace_id=new_trace_id(),
                ttft_slo_s=(parsed.ttft_slo_s if parsed.ttft_slo_s
                            is not None else cfg.ttft_slo_s),
                tpot_slo_s=(parsed.tpot_slo_s if parsed.tpot_slo_s
                            is not None else cfg.tpot_slo_s))
            stream = _Stream(req=req, queue=asyncio.Queue())
            self._streams[rid] = stream
            # the admission record goes in before the scheduler can see
            # the request: a request's ticks start with it in the ring
            self.flight.record_admission(
                req.rid, req.trace_id,
                wall_us=(time.perf_counter() - t0_admit) * 1e6,
                tick=self.batcher.stats.ticks)
            self._pending.append(req)
            self._cond.notify()
        if self.metrics is not None:
            self.metrics.gauge("serving_queue_depth",
                               "requests waiting for a batch slot").set(
                                   self._queue_depth())
        return stream

    # -- HTTP plumbing -------------------------------------------------------

    async def _write_response(self, writer: asyncio.StreamWriter,
                              status: int, body: bytes, content_type: str,
                              extra_headers: Tuple[Tuple[str, str], ...] = ()
                              ) -> None:
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  405: "Method Not Allowed", 429: "Too Many Requests",
                  500: "Internal Server Error"}.get(status, "OK")
        head = [f"HTTP/1.1 {status} {reason}",
                f"Content-Type: {content_type}",
                f"Content-Length: {len(body)}", "Connection: close"]
        head += [f"{k}: {v}" for k, v in extra_headers]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)
        await writer.drain()

    async def _write_json(self, writer, status: int, obj: Dict,
                          extra_headers=()) -> None:
        await self._write_response(
            writer, status, json.dumps(obj).encode(),
            "application/json", extra_headers)

    def _count_request(self, path: str, status: int) -> None:
        if self.metrics is not None:
            self.metrics.counter("server_requests_total",
                                 "HTTP requests served", path=path,
                                 status=str(status)).inc()

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        path = "?"
        try:
            request_line = await reader.readline()
            parts = request_line.decode("latin-1").split()
            if len(parts) < 2:
                return
            method, path = parts[0], parts[1]
            headers = {}
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                k, _, v = line.decode("latin-1").partition(":")
                headers[k.strip().lower()] = v.strip()
            body = b""
            length = int(headers.get("content-length", "0") or "0")
            if length:
                body = await reader.readexactly(length)
            status = await self._route(method, path, body, writer,
                                       headers=headers)
            self._count_request(path, status)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except api.ApiError as e:
            extra = ()
            if e.retry_after_s is not None:
                extra = (("Retry-After",
                          str(max(1, int(round(e.retry_after_s))))),)
            self._count_request(path, e.status)
            try:
                await self._write_json(writer, e.status, e.to_dict(), extra)
            except ConnectionError:
                pass
        except Exception as e:  # don't kill the server on a handler bug
            self._count_request(path, 500)
            try:
                await self._write_json(
                    writer, 500,
                    {"error": {"message": f"internal error: {e}",
                               "type": "internal_error"}})
            except ConnectionError:
                pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except ConnectionError:
                pass

    async def _route(self, method: str, path: str, body: bytes,
                     writer, headers: Optional[Dict[str, str]] = None
                     ) -> int:
        headers = headers or {}
        path, _, query = path.partition("?")
        if path == "/v1/models" and method == "GET":
            await self._write_json(
                writer, 200, api.models_response(self.cfg.model_id))
            return 200
        if path == "/metrics" and method == "GET":
            # content negotiation: OpenMetrics (trace-id exemplars on the
            # SLO histograms) via the Accept header or ?format=openmetrics;
            # plain Prometheus text otherwise
            want_om = ("application/openmetrics-text"
                       in headers.get("accept", "")
                       or "format=openmetrics" in query)
            if self.metrics is None:
                text, ctype = "", PROMETHEUS_CONTENT_TYPE
            elif want_om:
                text = self.metrics.render_openmetrics()
                ctype = OPENMETRICS_CONTENT_TYPE
            else:
                text = self.metrics.render_prometheus()
                ctype = PROMETHEUS_CONTENT_TYPE
            await self._write_response(writer, 200, text.encode(), ctype)
            return 200
        if path == "/healthz" and method == "GET":
            await self._write_json(
                writer, 200,
                {"status": "ok", "queue_depth": self._queue_depth(),
                 "active": len(self.batcher.active)})
            return 200
        if path == "/debug/flight" and method == "GET":
            await self._write_json(writer, 200, self.flight.to_dict())
            return 200
        if path.startswith("/debug/trace/") and method == "GET":
            key = path[len("/debug/trace/"):]
            trace = self.flight.request_trace(key)
            if trace is None:
                raise api.ApiError(
                    404, f"no flight-recorded ticks for request {key!r} "
                         "(evicted from the ring, or never served)",
                    code="trace_not_found")
            await self._write_json(writer, 200, trace)
            return 200
        if path == "/debug/drift" and method == "GET":
            await self._write_json(
                writer, 200,
                self.watchdog.to_dict() if self.watchdog is not None
                else {"enabled": False,
                      "engine_replans": getattr(self.engine, "replans", 0)})
            return 200
        if path == "/admin/shutdown" and method == "POST":
            await self._write_json(writer, 200, {"status": "stopping"})
            self.request_shutdown()
            return 200
        if path in ("/v1/completions", "/v1/chat/completions"):
            if method != "POST":
                raise api.ApiError(405, "use POST", code="method_not_allowed")
            try:
                payload = json.loads(body or b"{}")
            except json.JSONDecodeError as e:
                raise api.ApiError(400, f"invalid JSON body: {e}")
            parse = (api.CompletionRequest.parse_chat
                     if path == "/v1/chat/completions"
                     else api.CompletionRequest.parse)
            parsed = parse(payload, self.tokenizer)
            stream = self._admit_request(parsed)
            if parsed.stream:
                await self._stream_completion(writer, parsed, stream)
            else:
                await self._blocking_completion(writer, parsed, stream)
            return 200
        raise api.ApiError(404, f"no route {method} {path}",
                           code="not_found")

    # -- completion endpoints ------------------------------------------------

    async def _collect(self, stream: _Stream):
        """Yield ('token', id) items until the request completes."""
        while True:
            kind, value = await stream.queue.get()
            if kind == "done":
                return
            yield value

    async def _blocking_completion(self, writer, parsed, stream) -> None:
        tokens = [t async for t in self._collect(stream)]
        self._streams.pop(stream.req.rid, None)
        await self._write_json(
            writer, 200,
            api.completion_response(stream.req.rid, self.cfg.model_id,
                                    parsed, tokens, self.tokenizer,
                                    cached_tokens=stream.req.cached_tokens,
                                    trace_id=stream.req.trace_id))

    async def _stream_completion(self, writer, parsed, stream) -> None:
        head = ("HTTP/1.1 200 OK\r\n"
                "Content-Type: text/event-stream\r\n"
                "Cache-Control: no-cache\r\n"
                "Connection: close\r\n\r\n")
        writer.write(head.encode())
        await writer.drain()
        if self.metrics is not None:
            self.metrics.gauge("server_active_streams",
                               "open SSE responses").inc()
        try:
            index = 0
            async for tok in self._collect(stream):
                last = index + 1 >= parsed.max_tokens
                writer.write(api.sse_event(api.stream_chunk(
                    stream.req.rid, self.cfg.model_id, parsed, tok, index,
                    self.tokenizer, finish=last,
                    trace_id=stream.req.trace_id)))
                await writer.drain()
                index += 1
            writer.write(api.SSE_DONE)
            await writer.drain()
        finally:
            self._streams.pop(stream.req.rid, None)
            if self.metrics is not None:
                self.metrics.gauge("server_active_streams",
                                   "open SSE responses").dec()

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        """Bind the listening socket and start the scheduler thread; with
        a tracer, record every collection of the process as a ``gc``
        span until shutdown."""
        self._loop = asyncio.get_running_loop()
        self._shutdown_ev = asyncio.Event()
        if self.tracer is not None and self._gc_spans is None:
            self._gc_spans = GcSpans(self.tracer).install()
        self._sched_thread = threading.Thread(
            target=self._scheduler_loop, name="transql-scheduler",
            daemon=True)
        self._sched_thread.start()
        self._http = await asyncio.start_server(
            self._handle_conn, host=self.cfg.host, port=self.cfg.port)
        self.port = self._http.sockets[0].getsockname()[1]

    async def serve_forever(self) -> None:
        await self.start()
        try:
            await self._shutdown_ev.wait()
        finally:
            await self._aclose()

    def request_shutdown(self) -> None:
        """Threadsafe graceful-stop trigger (handler, signal, or test)."""
        if self._loop is not None and self._shutdown_ev is not None:
            self._loop.call_soon_threadsafe(self._shutdown_ev.set)

    async def _aclose(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._sched_thread is not None:
            self._sched_thread.join(timeout=10.0)
        if self._gc_spans is not None:
            self._gc_spans.remove()
            self._gc_spans = None
        if self._http is not None:
            self._http.close()
            await self._http.wait_closed()

    # -- test/driver convenience ----------------------------------------------

    def start_in_thread(self) -> threading.Thread:
        """Run the event loop in a daemon thread; returns once listening."""
        ready = threading.Event()

        def run():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)

            async def main():
                await self.start()
                ready.set()
                await self._shutdown_ev.wait()
                await self._aclose()

            try:
                loop.run_until_complete(main())
            finally:
                loop.close()

        t = threading.Thread(target=run, name="transql-server", daemon=True)
        t.start()
        if not ready.wait(timeout=60.0):
            raise RuntimeError("server failed to start within 60s")
        self._server_thread = t
        return t

    def shutdown(self, join_timeout: float = 30.0) -> None:
        """Stop a start_in_thread() server and wait for it to exit."""
        self.request_shutdown()
        t = getattr(self, "_server_thread", None)
        if t is not None:
            t.join(timeout=join_timeout)
