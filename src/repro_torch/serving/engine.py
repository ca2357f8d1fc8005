"""Serving engine: the paper's relational execution mode on one device.

``RelationalEngine`` compiles the Llama graph into relational pipelines
(prefill, decode, batched decode) over chunked weight tables and runs them
on the tensor executor; ``BatchedDecoder`` advances every active sequence
of a continuous batch in ONE pipeline call per tick.

Metrics: TTFT (prompt → first token) and TPOT (mean per subsequent token),
matching §4's definitions.  Host clocks around work that ends in a
device-to-host copy of the logits, so on a GPU they include the device
time.

This port runs the ``residency="in_memory"``, ``precision="f32"``,
unplanned (``row2col="off"``, ``cache_layout="off"``), unsharded
configuration, with the prefix cache (``BatchedDecoder(prefix_block=16)``,
the reference's default) and an optional ``metrics`` registry
(``repro_torch.obs.MetricsRegistry``); every other knob raises
``NotImplementedError`` naming the ROADMAP.md slice that brings it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import llama_graph as lg
from repro_torch.core.chunked import resolve_device
from repro_torch.core.graph import infer_shapes
from repro_torch.core.opmap import op_map
from repro_torch.core.passes import postoptimize, preoptimize
from repro_torch.core.pipeline import run_pipeline
from repro_torch.serving.kvcache import BatchedCacheTables, PrefixCache


@dataclasses.dataclass
class GenerationResult:
    tokens: List[int]
    ttft_s: float
    tpot_s: float
    peak_working_set: int = 0
    pager_stats: Optional[Dict] = None


def _not_ported(knob: str, value, slice_: str) -> NotImplementedError:
    return NotImplementedError(
        f"{knob}={value!r} is not ported yet: see ROADMAP.md next slice "
        f"{slice_}")


class RelationalEngine:
    """The paper's engine: two-stage-compiled pipelines over chunked tables.

    Takes the reference engine's parameters.  The defaults here are the
    values this port implements (``row2col="off"``, ``cache_layout="off"``);
    they become the reference's defaults once the planner is ported.
    ``device`` is where the weight tables, caches and every kernel live:
    the CUDA card unless the caller passes ``"cpu"``.  ``metrics`` is an
    optional ``repro_torch.obs.MetricsRegistry``: plan-cache lookups and
    single-sequence decode step latency here, decode ticks and the prefix
    cache in :class:`BatchedDecoder`, requests in the scheduler.
    """

    def __init__(self, spec: lg.LlamaSpec, params: Dict[str, object],
                 chunk_size=64, residency: str = "in_memory",
                 budget_bytes: Optional[int] = None,
                 disk_dir: Optional[str] = None, max_len: int = 1024,
                 pager_policy: str = "pin", row2col: str = "off",
                 cache_layout: str = "off",
                 chunk_candidates=None, cost_params=None,
                 precision: str = "f32",
                 table_precisions: Optional[Dict[str, str]] = None,
                 accuracy_budget: Optional[float] = None,
                 metrics=None, tracer=None, shards=None, device="cuda"):
        if row2col != "off":
            raise _not_ported("row2col", row2col, "N5 (planner)")
        if cache_layout != "off":
            raise _not_ported("cache_layout", cache_layout, "N5 (planner)")
        if not isinstance(chunk_size, int):
            raise _not_ported("chunk_size", chunk_size, "N5 (planner)")
        if chunk_candidates is not None or cost_params is not None:
            raise _not_ported("chunk_candidates/cost_params",
                              (chunk_candidates, cost_params),
                              "N5 (planner)")
        if precision != "f32" or table_precisions or \
                accuracy_budget is not None:
            raise _not_ported("precision", precision, "N4 (codecs)")
        if residency != "in_memory" or budget_bytes is not None or \
                disk_dir is not None or pager_policy != "pin":
            raise _not_ported("residency", residency, "N4 (pager)")
        if tracer is not None:
            raise _not_ported("tracer", tracer,
                              "N6 (observability and HTTP server)")
        if shards not in (None, 0, 1):
            raise _not_ported("shards", shards, "N7 (shards)")
        self.device = resolve_device(device)
        self.spec = spec
        self.cs = chunk_size
        self.max_len = max_len
        # zero-cost when None: every site guards with `is not None`
        self.metrics = metrics
        # the paged residency budget (N4); in-memory residency is unbounded
        self._residency_budget = None
        # prefill plans, keyed by (prompt length, suffix?): a suffix plan
        # takes the prefix boundary as the runtime :cache_position (the
        # append offset and the causal mask), so one plan per suffix
        # length serves every boundary
        self._prefill_pipes: Dict[tuple, object] = {}
        # batched decode plans, keyed by batch-size bucket — buckets are
        # powers of two: sessions join/leave the batch without replanning
        self._batched_pipes: Dict[int, object] = {}
        self.decode_pipe = self._compile_pipe(
            lg.build_decode_graph(spec, cache_len=max_len))
        self.env_base = lg.convert_weights(params, chunk_size=self.cs,
                                           device=self.device)

    def _compile_pipe(self, g):
        """Shared graph → pipeline compile path for every pipeline the
        engine builds (decode, prefill, batched decode)."""
        infer_shapes(g)
        preoptimize(g)
        pipe = op_map(g, chunk_size=self.cs)
        postoptimize(pipe)
        return pipe

    def _plan_cache_event(self, cache: str, hit: bool) -> None:
        if self.metrics is not None:
            self.metrics.counter(
                "engine_plan_cache_total",
                "compiled-plan cache lookups", cache=cache,
                outcome="hit" if hit else "miss").inc()

    def _prefill_pipe(self, T: int, suffix: bool = False):
        key = (T, suffix)
        self._plan_cache_event("prefill", key in self._prefill_pipes)
        if key not in self._prefill_pipes:
            self._prefill_pipes[key] = self._compile_pipe(
                lg.build_prefill_graph(self.spec, T, cache_len=self.max_len,
                                       suffix=suffix))
        return self._prefill_pipes[key]

    def _batched_decode_pipe(self, batch: int):
        """Compile (once per batch-size bucket) the seq-keyed decode plan
        that advances ``batch`` sequences in ONE ``run_pipeline`` call."""
        self._plan_cache_event("batched_decode", batch in self._batched_pipes)
        if batch not in self._batched_pipes:
            self._batched_pipes[batch] = self._compile_pipe(
                lg.build_decode_graph(self.spec, cache_len=self.max_len,
                                      batch=batch))
        return self._batched_pipes[batch]

    @staticmethod
    def _decode_bucket(batch: int) -> int:
        """Batch-size bucket (next power of two) a tick's plan is keyed by."""
        b = 1
        while b < batch:
            b *= 2
        return b

    def _fresh_env(self):
        env = dict(self.env_base)
        env.update(lg.empty_cache_tables(self.spec, cache_len=self.max_len,
                                         chunk_size=self.cs,
                                         device=self.device))
        return env

    def _final_logits(self, out_table) -> np.ndarray:
        """Final-position logits row (un-padded vocab), copied to the host."""
        v = out_table.cols["v"]
        return v.reshape(v.shape[0], -1)[-1, : self.spec.vocab].cpu().numpy()

    # -- incremental session API ---------------------------------------------

    def start_session(self, prompt: List[int]):
        """Prefill; returns a session dict holding env + cursor + first tok."""
        T = len(prompt)
        env = self._fresh_env()
        env["token_ids"] = lg.token_table(np.asarray(prompt),
                                          device=self.device)
        env["freq_each_token"] = lg.rope_freq_table(
            np.arange(T), self.spec.head_dim, self.spec.rope_theta,
            device=self.device)
        outs, env = run_pipeline(self._prefill_pipe(T), env,
                                 scalars={"cache_position": 0})
        logits = self._final_logits(outs["logits"])
        return {"env": env, "pos": T, "tok": int(np.argmax(logits)),
                "logits": logits}

    def start_suffix_session(self, prompt: List[int], boundary: int,
                             cache_tables: Dict[str, object]):
        """Prefill only ``prompt[boundary:]`` over caches already holding
        the prefix ``prompt[:boundary]`` (a shared prefix segment).

        ``cache_tables`` supplies the segment's ``k_cache_L*``/
        ``v_cache_L*`` tables, shared by reference: ``run_pipeline``'s
        append clones a cache table before it writes the new rows, so the
        segment is never written (copy-on-write past the boundary).  RoPE
        frequencies and the causal mask both place the suffix at absolute
        positions ``boundary .. len(prompt)-1``; the boundary is bound at
        runtime (``:cache_position``), so every boundary shares one
        compiled plan per suffix length.  The attention of a suffix of
        T > 1 tokens runs ``flash_attention`` with ``q_offset = boundary``;
        a one-token suffix has the decode step's mask and runs
        ``paged_attention``.
        """
        prompt = list(prompt)
        if boundary <= 0:
            return self.start_session(prompt)
        T = len(prompt) - boundary
        if T <= 0:
            raise ValueError(
                f"suffix prefill needs >= 1 new token: prompt length "
                f"{len(prompt)} <= boundary {boundary}")
        env = dict(self.env_base)
        env.update(cache_tables)
        env["token_ids"] = lg.token_table(np.asarray(prompt[boundary:]),
                                          device=self.device)
        env["freq_each_token"] = lg.rope_freq_table(
            np.arange(boundary, len(prompt)), self.spec.head_dim,
            self.spec.rope_theta, device=self.device)
        outs, env = run_pipeline(self._prefill_pipe(T, suffix=True), env,
                                 scalars={"cache_position": boundary})
        logits = self._final_logits(outs["logits"])
        return {"env": env, "pos": len(prompt),
                "tok": int(np.argmax(logits)), "logits": logits}

    def session_step(self, sess) -> int:
        """One KV-cached decode step (the §3.4 compact queries)."""
        env, pos, tok = sess["env"], sess["pos"], sess["tok"]
        env["token_ids"] = lg.token_table(np.asarray([tok]),
                                          device=self.device)
        env["freq_each_token"] = lg.rope_freq_table(
            np.asarray([pos]), self.spec.head_dim, self.spec.rope_theta,
            device=self.device)
        t0 = time.perf_counter() if self.metrics is not None else 0.0
        outs, env = run_pipeline(self.decode_pipe, env,
                                 scalars={"cache_position": pos})
        logits = self._final_logits(outs["logits"])
        if self.metrics is not None:
            self.metrics.histogram(
                "engine_decode_step_seconds",
                "single-sequence decode step latency").observe(
                    time.perf_counter() - t0)
        sess.update(env=env, pos=pos + 1, tok=int(np.argmax(logits)),
                    logits=logits)
        return sess["tok"]

    def generate(self, prompt: List[int], max_new_tokens: int
                 ) -> GenerationResult:
        t0 = time.perf_counter()
        sess = self.start_session(prompt)
        tokens = [sess["tok"]]
        ttft = time.perf_counter() - t0

        t1 = time.perf_counter()
        for _ in range(max_new_tokens - 1):
            tokens.append(self.session_step(sess))
        n_rest = max(1, max_new_tokens - 1)
        tpot = (time.perf_counter() - t1) / n_rest
        peak = sum(t.cols[c].numel() * t.cols[c].element_size()
                   for t in self.env_base.values() for c in t.cols)
        return GenerationResult(tokens, ttft, tpot, peak, None)

    # -- batched serving API (one relational plan per scheduler tick) ---------

    def batched_decoder(self, max_seqs: int, prefix_block: int = 16,
                        prefix_bind: str = "auto",
                        prefix_cache_bytes: Optional[int] = None
                        ) -> "BatchedDecoder":
        """Seq-slotted decode front-end: ``prefill``/``decode`` callbacks
        for :class:`~repro_torch.serving.scheduler.ContinuousBatcher`, with
        ``decode`` advancing ALL active sequences in ONE ``run_pipeline``
        call on the batched plan.

        ``prefix_block`` sizes the prefix cache's content-hash blocks
        (0 disables prefix caching); ``prefix_bind`` picks the segment
        bind mode (``"copy"`` / ``"share"`` / ``"auto"``);
        ``prefix_cache_bytes`` bounds the segment store (defaults to the
        engine's paged residency budget, which the port does not have
        yet: unbounded but for ``max_segments``)."""
        return BatchedDecoder(self, max_seqs, prefix_block=prefix_block,
                              prefix_bind=prefix_bind,
                              prefix_cache_bytes=prefix_cache_bytes)


class BatchedDecoder:
    """Batched relational decode over seq-slotted cache tables.

    Wraps a :class:`RelationalEngine` with the scheduler's callback shape:

      ``prefill(prompt, seq_id)``       — single-sequence prefill, cache
                                          rows copied into slot ``seq_id``
      ``prefill_ex(prompt, seq_id)``    — the same through the prefix
                                          cache: ``(token, cached_tokens)``
      ``decode(seq_ids, last_tokens)``  — ONE ``run_pipeline`` call on the
                                          batch-bucketed seq-keyed plan;
                                          per-sequence positions ride in as
                                          the ``seq_positions`` vector

    Ticks whose batch size is below the bucket pad by repeating the last
    sequence: the padded rows recompute that sequence's step and scatter
    back identical values, so padding is semantically free.
    """

    BIND_MODES = ("auto", "copy", "share")

    def __init__(self, engine: RelationalEngine, max_seqs: int,
                 prefix_block: int = 16, prefix_bind: str = "auto",
                 prefix_cache_bytes: Optional[int] = None):
        if prefix_bind not in self.BIND_MODES:
            raise ValueError(f"prefix_bind must be one of {self.BIND_MODES}, "
                             f"got {prefix_bind!r}")
        self.engine = engine
        self.pool = BatchedCacheTables(engine.spec, max_seqs, engine.max_len,
                                       engine.cs, device=engine.device)
        # content-hash prefix cache over completed prefills; prefill_ex
        # consults it, plain prefill() stays the cold path
        if prefix_cache_bytes is None:
            prefix_cache_bytes = engine._residency_budget
        self.prefix_cache = (None if not prefix_block else PrefixCache(
            block=prefix_block, budget_bytes=prefix_cache_bytes,
            metrics=engine.metrics))
        self.prefix_bind = prefix_bind
        self.decode_calls = 0  # == run_pipeline calls for decode ticks
        # gathered batch views cached across ticks: re-gathering the full
        # cache_len-deep tables every tick is O(B·cache_len) read traffic
        # when only one row per sequence changed — reuse last tick's
        # updated views while batch membership and slot contents are
        # unchanged.  The key is (slot ids, slot generations): the pool
        # bumps a slot's generation on every mutation outside decode
        # (prefill fill, free, binding changes).
        self._view_key: Optional[tuple] = None
        self._views: Optional[dict] = None

    def prefill(self, prompt: List[int], seq_id: int) -> int:
        # write_prefill overwrites the WHOLE slot (full cache_len) and bumps
        # the slot generation, invalidating any cached batch view over it
        self._unbind(seq_id)
        sess = self.engine.start_session(list(prompt))
        self.pool.write_prefill(seq_id, sess["env"], len(prompt))
        return sess["tok"]

    def prefill_ex(self, prompt: List[int], seq_id: int
                   ) -> "tuple[int, int]":
        """Prefix-cached prefill: ``(first_token, cached_tokens)``.

        Looks up the longest cached prefix, binds the slot to the shared
        segment (copy or share mode, see :meth:`_resolve_bind`) and runs
        the suffix-only prefill plan over ``prompt[cached:]``; on a miss
        it falls back to the cold path and interns the result as a new
        segment.  Token-exact either way: the suffix plan's causal mask
        and RoPE positions place the suffix at its absolute offsets, and
        the segment rows it attends to are the very tensors the donor
        prefill produced.
        """
        prompt = list(prompt)
        self._unbind(seq_id)  # slot reuse: drop any stale binding first
        pc = self.prefix_cache
        if pc is None:
            return self.prefill(prompt, seq_id), 0
        hit = pc.lookup(prompt)
        if hit is None:
            sess = self.engine.start_session(prompt)
            self.pool.write_prefill(seq_id, sess["env"], len(prompt))
            pc.insert(prompt, sess["env"])
            return sess["tok"], 0
        seg, boundary = hit
        sess = self.engine.start_suffix_session(prompt, boundary,
                                                seg.tables)
        if self._resolve_bind(boundary) == "share":
            # the slot holds only the divergent suffix; gathers splice the
            # segment's rows in (UNION-remap); the segment stays pinned
            pc.acquire(seg)
            self.pool.write_suffix(seq_id, sess["env"], len(prompt),
                                   boundary)
            self.pool.bind_segment(seq_id, seg, boundary)
        else:
            # bulk copy (INSERT ... SELECT): the slot owns a private full
            # copy, no pin, no gather-time splice
            self.pool.write_prefill(seq_id, sess["env"], len(prompt))
        # intern the extended prefix too (no-op if coverage unchanged)
        pc.insert(prompt, sess["env"])
        return sess["tok"], boundary

    def _resolve_bind(self, boundary: int) -> str:
        """Bind-mode pricing.  Copy costs one full-slot device write at
        bind; share saves that write but pins the segment and pays a
        boundary-row splice whenever batch membership changes.  Under a
        bounded residency budget the pin is what matters (shared rows are
        stored once), so ``auto`` shares; unconstrained, the cheaper
        steady-state decode path (no splice) wins and ``auto`` copies."""
        if self.prefix_bind != "auto":
            return self.prefix_bind
        return ("share" if self.engine._residency_budget is not None
                else "copy")

    def _unbind(self, seq_id: int) -> None:
        seg = self.pool.release_binding(seq_id)
        if seg is not None and self.prefix_cache is not None:
            self.prefix_cache.release(seg)

    def free(self, seq_id: int) -> None:
        self._unbind(seq_id)
        self.pool.free(seq_id)

    def decode(self, seq_ids: List[int], last_tokens: List[int]
               ) -> List[int]:
        eng = self.engine
        metrics = eng.metrics
        t0 = time.perf_counter() if metrics is not None else 0.0
        B = len(seq_ids)
        bucket = eng._decode_bucket(B)
        ids = list(seq_ids) + [seq_ids[-1]] * (bucket - B)
        toks = list(last_tokens) + [last_tokens[-1]] * (bucket - B)
        pipe = eng._batched_decode_pipe(bucket)
        positions = self.pool.positions[np.asarray(ids)]
        view_key = (tuple(ids), self.pool.slot_generations(ids))
        view_hit = self._view_key == view_key
        env = dict(eng.env_base)
        if view_hit:
            env.update(self._views)  # unchanged batch: reuse last views
        else:
            env.update(self.pool.gather_views(ids))
        if metrics is not None:
            metrics.counter("decoder_view_cache_total",
                            "batched cache-view gathers",
                            outcome="hit" if view_hit else "miss").inc()
        env["token_ids"] = lg.token_table(np.asarray(toks), key="seq",
                                          device=eng.device)
        env["freq_each_token"] = lg.rope_freq_table(
            positions, eng.spec.head_dim, eng.spec.rope_theta, key="seq",
            device=eng.device)
        outs, env = run_pipeline(pipe, env,
                                 scalars={"seq_positions": positions})
        self.decode_calls += 1
        # the tick's only cache mutation is one appended row per sequence
        # at positions[b] — write back just those rows; the updated views
        # (which already contain them) serve the next tick's gather
        self.pool.scatter_rows(ids, env, positions)
        self._views = {name: env[name] for name in self.pool.tables}
        self._view_key = view_key
        for s in seq_ids:
            self.pool.positions[s] += 1
        logits = outs["logits"].cols["v"].reshape(bucket, -1)[
            :B, : eng.spec.vocab].cpu().numpy()
        next_toks = [int(t) for t in np.argmax(logits, axis=1)]
        if metrics is not None:
            metrics.histogram(
                "decoder_tick_seconds",
                "batched decode tick latency").observe(
                    time.perf_counter() - t0)
            metrics.gauge("decoder_bucket_occupancy",
                          "live sequences / padded bucket size").set(
                              B / bucket)
        return next_toks
