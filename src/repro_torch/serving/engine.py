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
configuration; every other knob raises ``NotImplementedError`` naming the
ROADMAP.md slice that brings it.
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
from repro_torch.serving.kvcache import BatchedCacheTables


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
    the CUDA card unless the caller passes ``"cpu"``.
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
        if metrics is not None or tracer is not None:
            raise _not_ported("metrics/tracer", (metrics, tracer),
                              "N6 (observability and HTTP server)")
        if shards not in (None, 0, 1):
            raise _not_ported("shards", shards, "N7 (shards)")
        self.device = resolve_device(device)
        self.spec = spec
        self.cs = chunk_size
        self.max_len = max_len
        self._prefill_pipes: Dict[int, object] = {}
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

    def _prefill_pipe(self, T: int):
        if T not in self._prefill_pipes:
            self._prefill_pipes[T] = self._compile_pipe(
                lg.build_prefill_graph(self.spec, T, cache_len=self.max_len))
        return self._prefill_pipes[T]

    def _batched_decode_pipe(self, batch: int):
        """Compile (once per batch-size bucket) the seq-keyed decode plan
        that advances ``batch`` sequences in ONE ``run_pipeline`` call."""
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

    def session_step(self, sess) -> int:
        """One KV-cached decode step (the §3.4 compact queries)."""
        env, pos, tok = sess["env"], sess["pos"], sess["tok"]
        env["token_ids"] = lg.token_table(np.asarray([tok]),
                                          device=self.device)
        env["freq_each_token"] = lg.rope_freq_table(
            np.asarray([pos]), self.spec.head_dim, self.spec.rope_theta,
            device=self.device)
        outs, env = run_pipeline(self.decode_pipe, env,
                                 scalars={"cache_position": pos})
        logits = self._final_logits(outs["logits"])
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

    def batched_decoder(self, max_seqs: int, prefix_block: int = 0,
                        prefix_bind: str = "auto",
                        prefix_cache_bytes: Optional[int] = None
                        ) -> "BatchedDecoder":
        """Seq-slotted decode front-end: ``prefill``/``decode`` callbacks
        for :class:`~repro_torch.serving.scheduler.ContinuousBatcher`, with
        ``decode`` advancing ALL active sequences in ONE ``run_pipeline``
        call on the batched plan.  ``prefix_block`` must be 0 (no prefix
        cache) until the prefix cache is ported."""
        return BatchedDecoder(self, max_seqs, prefix_block=prefix_block,
                              prefix_bind=prefix_bind,
                              prefix_cache_bytes=prefix_cache_bytes)


class BatchedDecoder:
    """Batched relational decode over seq-slotted cache tables.

    Wraps a :class:`RelationalEngine` with the scheduler's callback shape:

      ``prefill(prompt, seq_id)``       — single-sequence prefill, cache
                                          rows copied into slot ``seq_id``
      ``decode(seq_ids, last_tokens)``  — ONE ``run_pipeline`` call on the
                                          batch-bucketed seq-keyed plan;
                                          per-sequence positions ride in as
                                          the ``seq_positions`` vector

    Ticks whose batch size is below the bucket pad by repeating the last
    sequence: the padded rows recompute that sequence's step and scatter
    back identical values, so padding is semantically free.
    """

    def __init__(self, engine: RelationalEngine, max_seqs: int,
                 prefix_block: int = 0, prefix_bind: str = "auto",
                 prefix_cache_bytes: Optional[int] = None):
        if prefix_block or prefix_bind != "auto" or \
                prefix_cache_bytes is not None:
            raise _not_ported("prefix_block", prefix_block,
                              "N2 (prefix cache)")
        self.engine = engine
        self.pool = BatchedCacheTables(engine.spec, max_seqs, engine.max_len,
                                       engine.cs, device=engine.device)
        self.decode_calls = 0  # == run_pipeline calls for decode ticks
        # gathered batch views cached across ticks: re-gathering the full
        # cache_len-deep tables every tick is O(B·cache_len) read traffic
        # when only one row per sequence changed — reuse last tick's
        # updated views while batch membership and slot contents are
        # unchanged.  The key is (slot ids, slot generations): the pool
        # bumps a slot's generation on every mutation outside decode.
        self._view_key: Optional[tuple] = None
        self._views: Optional[dict] = None

    def prefill(self, prompt: List[int], seq_id: int) -> int:
        # write_prefill overwrites the WHOLE slot (full cache_len) and bumps
        # the slot generation, invalidating any cached batch view over it
        sess = self.engine.start_session(list(prompt))
        self.pool.write_prefill(seq_id, sess["env"], len(prompt))
        return sess["tok"]

    def free(self, seq_id: int) -> None:
        self.pool.free(seq_id)

    def decode(self, seq_ids: List[int], last_tokens: List[int]
               ) -> List[int]:
        eng = self.engine
        B = len(seq_ids)
        bucket = eng._decode_bucket(B)
        ids = list(seq_ids) + [seq_ids[-1]] * (bucket - B)
        toks = list(last_tokens) + [last_tokens[-1]] * (bucket - B)
        pipe = eng._batched_decode_pipe(bucket)
        positions = self.pool.positions[np.asarray(ids)]
        view_key = (tuple(ids), self.pool.slot_generations(ids))
        env = dict(eng.env_base)
        if self._view_key == view_key:
            env.update(self._views)  # unchanged batch: reuse last views
        else:
            env.update(self.pool.gather_views(ids))
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
        return [int(t) for t in np.argmax(logits, axis=1)]
