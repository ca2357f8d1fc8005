"""The system under test: the port's HTTP server over its relational engine.

``System`` makes ``AsyncLLMServer`` over ``RelationalEngine`` (and
through it ``BatchedDecoder`` and ``ContinuousBatcher``) from a
configuration's ``engine`` settings, with the weights drawn from the
seed; the configuration's architecture (``archs/<model>.py``) builds the
engine and sizes the page pool.  ``warm_up`` serves requests through the
batcher before the server listens, so every plan the window touches is
compiled; ``Watch`` records each prefill and decode call the batcher
makes and, in a traced run, profiles the card between the window's
edges.  The program's tracer and drift watchdog stay off: the tracer,
forced on, costs 3-13 % of tokens/s on the card, and a re-plan is not a
steady state.  Everything else is as the port's server entry
(``examples/serve_http_torch.py``) builds it: the scheduler's
``PagedKVCache`` on the card, the prefix store's default bound.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Dict, List, Optional

import torch

from portbench.model import SeededWeights, architecture


class GcPauses:
    """Full (generation 2) collections of the serving process, from
    ``gc.callbacks``: ``(start, end)`` on the monotonic clock."""

    def __init__(self):
        self.full: List[tuple] = []
        self._t0 = None
        gc.callbacks.append(self)

    def __call__(self, phase, info):
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._t0 = time.monotonic()
        elif self._t0 is not None:
            self.full.append((self._t0, time.monotonic()))
            self._t0 = None

    def close(self):
        gc.callbacks.remove(self)

    def within(self, a: float, b: float):
        inside = [e - s for s, e in self.full if a <= s < b]
        return len(inside), sum(inside)


class Watch:
    """Wraps the batcher's prefill and decode calls.

    Between the first call that starts at or after ``t_open`` and the
    first that starts at or after ``t_close`` (``time.monotonic``), it
    keeps ``(kind, start_ns, end_ns, ...)`` of every call, snapshots the
    program's counters at both edges and, with ``trace``, runs a
    CUDA-only ``torch.profiler`` over exactly those calls.  The gate runs
    on the scheduler's thread, so no call is cut in two."""

    def __init__(self, system: "System", trace: bool):
        self.system = system
        self.t_open: Optional[float] = None
        self.t_close: Optional[float] = None
        self.state = "idle"
        self.prefills: List[tuple] = []   # (start_ns, end_ns, context, cached)
        self.decodes: List[tuple] = []    # (start_ns, end_ns, rows, keys)
        self.edges: Dict[str, Dict] = {}
        self.open_ns = self.close_ns = 0
        self.closed = threading.Event()
        self.prof = None
        if trace:
            self.prof = system.profiler()
        batcher = system.server.batcher
        batcher.prefill_fn = self._prefill(batcher.prefill_fn)
        batcher.decode_fn = self._decode(batcher.decode_fn)

    def _gate(self) -> bool:
        if self.t_open is None or self.state == "closed":
            return False
        now = time.monotonic()
        if self.state == "idle" and now >= self.t_open:
            self.system.sync()
            self.edges["open"] = self.system.counters()
            if self.prof is not None:
                self.prof.start()
            self.open_ns = time.time_ns()
            self.state = "open"
        elif self.state == "open" and now >= self.t_close:
            self.system.sync()
            self.close_ns = time.time_ns()
            if self.prof is not None:
                self.prof.stop()
            self.edges["close"] = self.system.counters()
            self.state = "closed"
            self.closed.set()
        return self.state == "open"

    def _prefill(self, inner):
        def prefill(req, seq_id):
            counted = self._gate()
            t0 = time.time_ns()
            res = inner(req, seq_id)
            if counted:
                cached = res[1] if isinstance(res, tuple) else 0
                self.prefills.append((t0, time.time_ns(), len(req.context),
                                      int(cached)))
            return res
        return prefill

    def _decode(self, inner):
        positions = self.system.decoder.pool.positions

        def decode(seq_ids, last_tokens):
            counted = self._gate()
            keys = int(sum(int(positions[s]) + 1 for s in seq_ids))
            t0 = time.time_ns()
            out = inner(seq_ids, last_tokens)
            if counted:
                self.decodes.append((t0, time.time_ns(), len(seq_ids), keys))
            return out
        return decode

    def calls(self):
        return ([("prefill", a, b) for a, b, *_ in self.prefills]
                + [("decode", a, b) for a, b, *_ in self.decodes])


class System:
    def __init__(self, cfg: Dict, seed: int, device):
        from repro_torch.serving.kvcache import PagedKVCache
        from repro_torch.serving.server import AsyncLLMServer, ServerConfig

        self.device = torch.device(device)
        self.arch = a = architecture(cfg)
        self.shapes = s = a.shapes(cfg)
        e = cfg["engine"]
        self.slots = e["slots"]
        self.engine, kv_cfg = a.build(
            s, cfg, SeededWeights(a, s, seed, self.device), self.device)
        kv = PagedKVCache(kv_cfg, max_seqs=self.slots, device=self.device)
        self.server = AsyncLLMServer(self.engine, kv, ServerConfig(
            host="127.0.0.1", port=0, model_id=cfg["name"],
            max_batch=self.slots, max_queue_depth=4 * self.slots,
            max_tokens_cap=e["max_tokens_cap"], drift_every=0))
        self.decoder = self.server.decoder
        self.watch: Optional[Watch] = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def counters(self) -> Dict[str, int]:
        from repro_torch.kernels.chunked_matmul import chunked_matmul
        st = self.server.batcher.stats
        out = {"decode_calls": self.decoder.decode_calls,
               "ticks": st.ticks, "completed": st.completed,
               "prefills": st.prefills, "preemptions": st.preemptions,
               "k1_calls": chunked_matmul.calls,
               "k1_launches": chunked_matmul.launches}
        pc = self.decoder.prefix_cache
        if pc is not None:
            out.update(prefix_cached_tokens=pc.stats.cached_tokens,
                       prefix_hits=pc.stats.hits,
                       prefix_misses=pc.stats.misses)
        pager = self.engine.pager
        if pager is not None:
            out.update(pager_bytes_loaded=pager.stats.bytes_loaded,
                       pager_hits=pager.stats.hits,
                       pager_misses=pager.stats.misses,
                       pager_prefetch_hits=pager.stats.prefetch_hits)
        out.update(self.arch.counters(self.engine))
        return out

    def warm_up(self, reqs) -> None:
        """Serve ``reqs`` through the batcher on this thread, to the end."""
        from repro_torch.serving.scheduler import Request
        batcher = self.server.batcher
        for j, r in enumerate(reqs):
            batcher.submit(Request(rid=-1 - j, prompt=list(r.prompt),
                                   max_new_tokens=r.max_tokens))
        while batcher.tick():
            pass
        self.sync()

    def watch_window(self, trace: bool) -> Watch:
        self.watch = Watch(self, trace)
        if trace:
            # the profiler's first start initialises CUPTI: do it here, in
            # the set-up, not inside the window
            with self.profiler():
                torch.ones(1, device=self.device).add_(1)
                self.sync()
        return self.watch

    def profiler(self):
        """A profiler of the card's activity alone (of the CPU's, where
        the engine runs on the CPU, as in the tests)."""
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CUDA
                                   if self.device.type == "cuda"
                                   else ProfilerActivity.CPU])

    def start(self) -> int:
        self.server.start_in_thread()
        return self.server.port

    def memory_peak_bytes(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def close(self) -> None:
        """Stop the server and free the engine's state on the device.

        The streams whose clients left at the window's close still wait
        for tokens, which the stopped scheduler will not send, and the
        HTTP server does not close while a stream is open: once the
        scheduler has stopped, each is ended as a finished request."""
        srv = self.server
        srv.request_shutdown()
        srv._sched_thread.join(timeout=60)
        if srv._sched_thread.is_alive():
            raise RuntimeError("the scheduler thread did not stop")
        for stream in list(srv._streams.values()):
            srv._loop.call_soon_threadsafe(stream.queue.put_nowait,
                                           ("done", None))
        srv._server_thread.join(timeout=60)
        if srv._server_thread.is_alive():
            raise RuntimeError("the HTTP server's thread did not stop")
        self.server = self.engine = self.decoder = None
        if self.watch is not None:
            self.watch.system = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
