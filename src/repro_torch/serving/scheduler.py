"""Continuous-batching scheduler over the paged KV cache.

Requests arrive with a prompt and a token budget; the scheduler admits them
into free batch slots, prefills, then advances all active sequences one
decode step per tick (iteration-level scheduling).  When the page pool runs
dry it preempts the youngest sequence (free its pages, re-queue) — the
standard vLLM-style policy, here over the paper's KV-cache *tables*.

Streaming front ends (``repro_torch.serving.server``) hook in through two
callbacks — ``on_token(req, tok)`` fires as each token is generated (at
prefill and after every decode tick) and ``on_done(req)`` when a request
completes — so tokens leave the batch without polling.  Preemption
preserves a request's already-generated tokens: re-admission prefills over
``req.context`` (prompt + delivered tokens) and decoding resumes at the
next position instead of re-sampling the delivered prefix.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from repro_torch.obs.context import TraceContext, activate, new_trace_id
from repro_torch.serving.kvcache import PagedKVCache


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    arrival_s: float = 0.0
    # end-to-end trace id: minted at HTTP admission (or at submit() when
    # the front end didn't) and carried through every span / DB operator
    # the request touches — the key of /debug/trace/{id}
    trace_id: str = ""
    # serving SLOs (seconds, relative): used for violation accounting and
    # to prefer already-past-deadline victims at preemption time
    ttft_slo_s: Optional[float] = None
    tpot_slo_s: Optional[float] = None
    # filled by the scheduler:
    generated: List[int] = dataclasses.field(default_factory=list)
    first_token_s: Optional[float] = None
    done_s: Optional[float] = None
    preemptions: int = 0
    # prompt tokens served from the prefix cache at the FIRST admission
    # (the OpenAI usage `prompt_tokens_details.cached_tokens` field); a
    # preemption-resume re-prefill may hit the cache again, but usage
    # reports the original admission's reuse, so it is recorded once
    cached_tokens: int = 0
    # why the scheduler gave the request up (``on_done`` still fires):
    # "context_exceeds_pool" when its full context can never fit the pool
    error: Optional[str] = None

    @property
    def context(self) -> List[int]:
        """Tokens to prefill over on (re-)admission: the prompt plus any
        tokens generated before a preemption.  Preserving the generated
        prefix keeps re-admission from re-sampling tokens a streaming
        consumer has already been sent."""
        return list(self.prompt) + list(self.generated)

    def deadline_budget_s(self) -> Optional[float]:
        """Total latency budget implied by the SLOs (None when unset)."""
        if self.ttft_slo_s is None and self.tpot_slo_s is None:
            return None
        budget = self.ttft_slo_s or 0.0
        if self.tpot_slo_s is not None:
            budget += self.tpot_slo_s * max(0, self.max_new_tokens - 1)
        return budget

    def past_deadline(self, now_s: float) -> bool:
        budget = self.deadline_budget_s()
        return budget is not None and (now_s - self.arrival_s) > budget


def pages_needed(n_tokens: int, page_size: int) -> int:
    """Pages a sequence of ``n_tokens`` holds, plus the one a decode step
    may open."""
    return -(-n_tokens // page_size) + 1


@dataclasses.dataclass
class SchedulerStats:
    ticks: int = 0
    # prefill invocations split by kind: a preemption-resume re-prefill is
    # forced work (it was admitted before), and a prefix hit skipped most
    # of its plan — lumping them with cold admits (the old single
    # `prefills` counter) hid both the resume overhead and the hit rate
    prefills_cold: int = 0
    prefills_resume: int = 0
    prefills_prefix_hit: int = 0
    decode_steps: int = 0
    preemptions: int = 0
    completed: int = 0

    @property
    def prefills(self) -> int:
        """Total prefill invocations (back-compat with the single counter)."""
        return (self.prefills_cold + self.prefills_resume
                + self.prefills_prefix_hit)


class ContinuousBatcher:
    """Iteration-level scheduler.

    ``prefill_fn(request, seq_id)`` must fill the KV cache for
    ``request.context`` (prompt + preserved generated prefix — NOT just the
    prompt, or a preempted request would re-sample tokens it already
    delivered) and return the next generated token;
    ``decode_fn(seq_ids, last_tokens)`` advances every active sequence one
    step and returns the next tokens.  ``release_fn(seq_id)``, when given,
    is called whenever a sequence leaves the batch (completion or
    preemption) so decode-side state keyed by slot — e.g. a
    ``BatchedDecoder``'s cache pool (pass ``dec.free``) — is released
    alongside the KV pages.

    ``on_token(req, tok)`` / ``on_done(req)``, when given, are called from
    the scheduler thread as tokens are generated and requests complete —
    the streaming handoff for the async HTTP front end.

    The scheduler owns ``kv.seq_lens`` end to end (context length at
    admit, +1 per decode tick): prefill_fn/decode_fn implementations must
    NOT advance it themselves.  In particular a decode_fn built on
    ``PagedKVCache.append`` (which also bumps ``seq_lens``) would
    double-advance — write at the pre-tick position and let the scheduler
    account for it.
    """

    def __init__(self, kv: PagedKVCache, prefill_fn: Callable,
                 decode_fn: Callable, max_batch: int,
                 release_fn: Optional[Callable] = None, metrics=None,
                 on_token: Optional[Callable] = None,
                 on_done: Optional[Callable] = None,
                 tracer=None, flight=None, watchdog=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_batch > kv.max_seqs:
            # an unvalidated max_batch used to surface later as a bare
            # StopIteration from the free-slot search in _admit
            raise ValueError(
                f"max_batch ({max_batch}) exceeds the KV cache's "
                f"max_seqs ({kv.max_seqs}): the batch can never fill")
        self.kv = kv
        self.prefill_fn = prefill_fn
        self.decode_fn = decode_fn
        self.release_fn = release_fn
        self.max_batch = max_batch
        self.queue: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}   # seq_id -> request
        self.finished: List[Request] = []
        self.stats = SchedulerStats()
        # optional repro_torch.obs.metrics.MetricsRegistry: TTFT / TPOT /
        # tick histograms, occupancy gauge, preemption + completion + SLO
        # violation counters
        self.metrics = metrics
        self.on_token = on_token
        self.on_done = on_done
        # optional repro_torch.obs wiring (all three default off = zero
        # cost):
        # tracer  — the engine's TraceRecorder; when a flight recorder is
        #           given too, the batcher DRAINS it after every prefill/
        #           decode (every span since the last drain) so a
        #           long-running server never accumulates an unbounded
        #           span list (the flight ring is the retention policy)
        # flight  — repro_torch.obs.flight.FlightRecorder receiving one
        #           record per prefill/decode tick with the request ids it
        #           served
        # watchdog — object with on_tick() called after each decode at a
        #           tick boundary
        #           (repro_torch.serving.watchdog.DriftWatchdog)
        self.tracer = tracer
        self.flight = flight
        self.watchdog = watchdog

    def _release(self, seq_id: int) -> None:
        self.kv.free_seq(seq_id)
        if self.release_fn is not None:
            self.release_fn(seq_id)

    def submit(self, req: Request) -> None:
        req.arrival_s = time.perf_counter()
        if not req.trace_id:
            req.trace_id = new_trace_id()
        self.queue.append(req)

    def _emit(self, req: Request, tok: int) -> None:
        if self.on_token is not None:
            self.on_token(req, tok)

    def _finish(self, req: Request, seq_id: int) -> None:
        req.done_s = time.perf_counter() - req.arrival_s
        self.finished.append(req)
        self.stats.completed += 1
        # TPOT over the tokens after the first (matches §4's definition;
        # a 1-token request has no inter-token gaps)
        gaps = max(1, len(req.generated) - 1)
        tpot = (req.done_s - (req.first_token_s or 0.0)) / gaps
        ttft_violated = (req.ttft_slo_s is not None
                         and req.first_token_s is not None
                         and req.first_token_s > req.ttft_slo_s)
        tpot_violated = req.tpot_slo_s is not None and tpot > req.tpot_slo_s
        if self.metrics is not None:
            self.metrics.counter("serving_completed_total",
                                 "requests finished").inc()
            # the exemplar links this observation's bucket to the
            # request's /debug/trace/{trace_id} dump (OpenMetrics render)
            self.metrics.histogram(
                "serving_tpot_seconds",
                "mean time per output token after the first").observe(
                    tpot, exemplar=req.trace_id)
            if ttft_violated:
                self.metrics.counter(
                    "serving_slo_violations_total",
                    "completions that missed an SLO", kind="ttft").inc()
            if tpot_violated:
                self.metrics.counter(
                    "serving_slo_violations_total",
                    "completions that missed an SLO", kind="tpot").inc()
        if self.flight is not None and (ttft_violated or tpot_violated):
            # SLO violators pin their full traces as exemplars so the
            # interesting ticks outlive the flight ring
            self.flight.pin(req.trace_id, reason="slo")
        self._release(seq_id)
        if self.on_done is not None:
            self.on_done(req)

    def _record_tick(self, kind: str, ts_us: float, wall_s: float,
                     request_ids, trace_ids) -> None:
        """One flight record for a prefill or decode call that started at
        ``ts_us`` (the flight recorder's clock) and took ``wall_s``, with
        every span the tracer recorded since the last one: the call's,
        and those other threads (the pager's prefetch, a collection)
        recorded between calls."""
        spans = (self.tracer.drain_records() if self.tracer is not None
                 else ())
        self.flight.record_tick(kind, spans=spans, wall_us=wall_s * 1e6,
                                tick=self.stats.ticks,
                                request_ids=request_ids,
                                trace_ids=trace_ids, ts_us=ts_us)

    def _admit(self) -> None:
        while self.queue and len(self.active) < self.max_batch:
            req = self.queue[0]
            if pages_needed(len(req.prompt) + req.max_new_tokens,
                            self.kv.cfg.page_size) > self.kv.cfg.n_pages:
                # it can never fit, even alone: waiting for pages would
                # leave the queue stuck behind it forever
                self.queue.popleft()
                req.error = "context_exceeds_pool"
                req.done_s = time.perf_counter() - req.arrival_s
                if self.on_done is not None:
                    self.on_done(req)
                continue
            # a preempted request re-prefills over its full context
            # (prompt + preserved generated prefix), so page demand grows
            # with what it already produced
            ctx_len = len(req.prompt) + len(req.generated)
            need = pages_needed(ctx_len, self.kv.cfg.page_size)
            if self.kv.free_page_count() < need:
                break
            seq_id = next((i for i in range(self.kv.max_seqs)
                           if not self.kv._active.get(i, False)), None)
            if seq_id is None:
                # every KV slot is occupied (defensive: max_batch is
                # validated <= max_seqs at construction, but slots may be
                # held outside this scheduler) — admit once one frees
                break
            self.queue.popleft()
            self.kv.allocate_seq(seq_id)
            # prefill_fn may return a bare token (legacy contract) or
            # (token, cached_tokens) — the prefix-cached decoders report
            # how much of the context they skipped via a shared segment.
            # The prefill runs under the request's own TraceContext, so
            # every span it emits (pipeline steps, pager fetches, shard
            # work) is stamped with this rid/trace_id.
            pctx = TraceContext.for_request(req.rid, req.trace_id,
                                            phase="prefill",
                                            tick=self.stats.ticks)
            ts = self.flight.now_us() if self.flight is not None else 0.0
            t0p = time.perf_counter()
            with activate(pctx):
                res = self.prefill_fn(req, seq_id)
            if self.flight is not None:
                self._record_tick("prefill", ts, time.perf_counter() - t0p,
                                  (req.rid,), (req.trace_id,))
            tok, cached = res if isinstance(res, tuple) else (res, 0)
            # the scheduler owns kv.seq_lens end to end: the context length
            # here, the per-tick decode increment in tick()
            self.kv.seq_lens[seq_id] = ctx_len
            if req.preemptions > 0:
                # resume re-prefill: even on a prefix hit, this admission
                # is forced re-work, not new traffic — count it as resume
                # (and don't let the re-prefill's reuse inflate the
                # request's reported cached_tokens)
                self.stats.prefills_resume += 1
            elif cached > 0:
                self.stats.prefills_prefix_hit += 1
                req.cached_tokens = int(cached)
            else:
                self.stats.prefills_cold += 1
            if self.metrics is not None:
                kind = ("resume" if req.preemptions > 0
                        else ("prefix_hit" if cached > 0 else "cold"))
                self.metrics.counter(
                    "serving_prefills_total",
                    "prefill invocations by kind", kind=kind).inc()
            req.generated.append(tok)
            if req.first_token_s is None:
                # a preempted request re-prefills, but its first token was
                # already delivered — TTFT is measured once, at the first
                # prefill, and must not be overwritten by the re-admission
                req.first_token_s = time.perf_counter() - req.arrival_s
                if self.metrics is not None:
                    self.metrics.histogram(
                        "serving_ttft_seconds",
                        "time to first token").observe(
                            req.first_token_s, exemplar=req.trace_id)
            self._emit(req, tok)
            if len(req.generated) >= req.max_new_tokens:
                # the prefill token already met the budget (e.g.
                # max_new_tokens=1): complete NOW — waiting for a decode
                # tick would generate one token too many
                self._finish(req, seq_id)
                continue
            self.active[seq_id] = req

    def _preempt(self, seq_id: int) -> None:
        req = self.active.pop(seq_id)
        self._release(seq_id)
        # req.generated is preserved: those tokens were (possibly) already
        # streamed to a consumer, so re-admission must resume after them,
        # not re-sample them
        req.preemptions += 1
        self.stats.preemptions += 1
        if self.metrics is not None:
            self.metrics.counter("serving_preemptions_total",
                                 "sequences preempted for pages").inc()
        self.queue.appendleft(req)

    def _preemption_victim(self, victims: List[int]) -> int:
        """Choose the sequence to evict when the page pool runs dry.

        Requests already past their SLO deadline go first (their latency
        target is lost either way; protecting them starves requests that
        can still meet theirs); ties and the no-deadline case fall back to
        the youngest-arrival policy.
        """
        now = time.perf_counter()
        expired = [s for s in victims if self.active[s].past_deadline(now)]
        pool = expired or victims
        victim = max(pool, key=lambda s: self.active[s].arrival_s)
        if expired and self.metrics is not None:
            self.metrics.counter(
                "serving_deadline_preemptions_total",
                "preemptions that chose a past-deadline victim").inc()
        return victim

    def tick(self) -> bool:
        """One scheduler iteration. Returns False when fully drained."""
        self.stats.ticks += 1
        self._admit()
        if not self.active:
            return bool(self.queue)

        # grow pages for this step; preempt other sequences until the
        # current one fits (never the current seq itself — its pages are the
        # work we are protecting; stale entries are skipped since a preempted
        # victim may already have left the snapshot)
        for seq_id in list(self.active):
            if seq_id not in self.active:
                continue
            req = self.active[seq_id]
            pos = len(req.prompt) + len(req.generated)
            while True:
                try:
                    self.kv.ensure_capacity(seq_id, pos + 1)
                    break
                except RuntimeError:
                    victims = [s for s in self.active if s != seq_id]
                    if not victims:
                        raise RuntimeError(
                            "a single sequence exceeds the page pool")
                    self._preempt(self._preemption_victim(victims))

        seq_ids = sorted(self.active)
        last = [self.active[s].generated[-1] for s in seq_ids]
        # a batched decode tick serves every active request at once: the
        # context carries all of them, and every span the tick emits is
        # stamped with the full set
        dctx = TraceContext(
            request_ids=tuple(self.active[s].rid for s in seq_ids),
            trace_ids=tuple(self.active[s].trace_id for s in seq_ids),
            phase="decode", tick=self.stats.ticks)
        ts = self.flight.now_us() if self.flight is not None else 0.0
        t0 = time.perf_counter()
        with activate(dctx):
            next_tokens = self.decode_fn(seq_ids, last)
        t1 = time.perf_counter()
        self.stats.decode_steps += 1
        if self.flight is not None:
            self._record_tick("decode", ts, t1 - t0, dctx.request_ids,
                              dctx.trace_ids)
        if self.metrics is not None:
            self.metrics.histogram(
                "serving_tick_seconds",
                "decode tick latency").observe(t1 - t0)
            self.metrics.gauge(
                "serving_active_sequences",
                "sequences in the running batch").set(len(seq_ids))
            self.metrics.gauge(
                "serving_batch_occupancy",
                "active sequences / max_batch").set(
                    len(seq_ids) / self.max_batch)
        # one decode step appended one token per active sequence: the
        # scheduler owns this bookkeeping so decode_fn implementations
        # don't each have to repeat (or forget) it
        for s in seq_ids:
            self.kv.seq_lens[s] += 1

        for seq_id, tok in zip(seq_ids, next_tokens):
            req = self.active[seq_id]
            req.generated.append(int(tok))
            self._emit(req, int(tok))
            if len(req.generated) >= req.max_new_tokens:
                self._finish(req, seq_id)
                del self.active[seq_id]
        if self.watchdog is not None:
            # tick boundary: no plan is mid-flight, so the watchdog may
            # swap the engine's compiled pipelines here
            self.watchdog.on_tick()
        return bool(self.active or self.queue)

    def run(self, max_ticks: int = 100000) -> List[Request]:
        for _ in range(max_ticks):
            if not self.tick():
                break
        return self.finished
