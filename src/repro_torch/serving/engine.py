"""Serving engine: the paper's relational execution mode on one device.

``RelationalEngine`` compiles the Llama graph into relational pipelines
(prefill, decode, batched decode) over chunked weight tables and runs them
on the tensor executor; ``BatchedDecoder`` advances every active sequence
of a continuous batch in ONE pipeline call per tick.

Metrics: TTFT (prompt → first token) and TPOT (mean per subsequent token),
matching §4's definitions.  Host clocks around work that ends in a
device-to-host copy of the logits, so on a GPU they include the device
time.

This port runs the reference's defaults: every pipeline is physically
planned (``row2col="auto"``, ``cache_layout="auto"``: ROW2COL column
weight layouts and the planner's KV-cache key order), with ``chunk_size``,
``chunk_candidates``, ``cost_params``, ``precision``, ``table_precisions``
and ``accuracy_budget`` as in the reference, both residencies
(``residency="in_memory"``, or ``"paged"``: the paper's Disk+mem mode,
weight tables streaming through a bounded :class:`~repro_torch.serving.
pager.WeightPager` working set), ``shards`` (the planner's tensor-parallel
axis run by :mod:`repro_torch.serving.shards`), the prefix cache
(``BatchedDecoder(prefix_block=16)``), an optional ``metrics`` registry
(``repro_torch.obs.MetricsRegistry``) and an optional ``tracer``
(``repro_torch.obs.TraceRecorder``: the reference's plan-compile, session,
decoder-phase, pipeline-step, op, pager and shard spans).

The reference's docstring says its relational pager prefetches the next
layer's tables during compute; its code prefetches only the
``vocabulary`` table at the start of each session, and so does this port.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import llama_graph as lg
from repro_torch.core import relational as ra
from repro_torch.core.chunked import ChunkedTensor, resolve_device
from repro_torch.core.executor import DenseTable, table_from_chunked
from repro_torch.core.graph import infer_shapes
from repro_torch.core.opmap import op_map
from repro_torch.core.passes import postoptimize, preoptimize
from repro_torch.core.pipeline import run_pipeline, step_span_args
from repro_torch.planner import CACHE_MODES, MODES, ResidencyPool
from repro_torch.quant.codecs import CODECS, quantise_dense
from repro_torch.serving.kvcache import BatchedCacheTables, PrefixCache
from repro_torch.serving.pager import WeightPager


@dataclasses.dataclass
class GenerationResult:
    tokens: List[int]
    ttft_s: float
    tpot_s: float
    peak_working_set: int = 0
    pager_stats: Optional[Dict] = None


class LazyEnv(dict):
    """Environment that pages weight tables in on first Scan.

    COL_CHUNK tables introduced by the layout planner are converted
    *offline* into the pager's cold store (``RelationalEngine.
    _register_layouts``), so they page through the same working-set budget
    as every other weight — ``resolves_layouts`` tells
    ``LayoutPlan.ensure_env`` not to materialise resident copies here.

    ``table_sizes`` maps table names to planner-chosen physical chunk
    sizes (``chunk_size="auto"``); tables absent there wrap at the
    engine's base chunking.  ``quant_specs`` maps quantised table names to
    ``(precision, chunk_size, schema)``: their packed integer codes and
    per-group scales page as two cold entries (``name::q`` /
    ``name::scale``) whose *quantised* byte sizes are what the pager
    accounts.  Both dicts are shared by reference with the engine so
    later-planned pipelines (prefill, batched decode) extend them in place.

    A fetched table is wrapped where it lies, without a copy (the
    reference goes through numpy): the cold store keeps the ``pad_to``
    padding, so the chunk size divides the stored width and the chunked
    table is a view of the pager's hot tensor.
    """

    resolves_layouts = True

    def __init__(self, pager: WeightPager, chunk_size: int, make_table,
                 table_sizes=None, quant_specs=None):
        super().__init__()
        self.pager = pager
        self.cs = chunk_size
        self.make_table = make_table
        self.table_sizes = table_sizes if table_sizes is not None else {}
        self.quant_specs = quant_specs if quant_specs is not None else {}

    @property
    def device(self):
        """Where the fetched tables lie (``run_pipeline`` reads it)."""
        return self.pager.device

    def __missing__(self, key):
        spec = self.quant_specs.get(key)
        if spec is not None:
            return self._quant_table(key, *spec)
        arr = self.pager.get(key)
        cs = self.table_sizes.get(key, self.cs)
        # don't retain: the pager owns residency, we re-wrap per access
        return self.make_table(key, arr, cs)

    def _quant_table(self, key, precision, chunk_size, schema):
        """Wrap a quantised table's paged code/scale tensors (codes stay
        integer; the dequant happens inside the projection the planner
        emitted).  Packed nf4 codes are unpacked on the device."""
        codes = CODECS[precision].unpack(self.pager.get(key + "::q"),
                                         chunk_size)
        scales = self.pager.get(key + "::scale")
        (q_col, q_type), (s_col, _) = schema.cols
        want = tuple(s for _, s in schema.keys)
        if tuple(codes.shape) != want + (chunk_size,):
            raise ValueError(
                f"quantised table {key!r}: stored code shape "
                f"{tuple(codes.shape)} != schema {want + (chunk_size,)}")
        return DenseTable(keys=schema.keys,
                          cols={q_col: codes, s_col: scales},
                          col_types={q_col: q_type, s_col: ra.SCALAR})

    def __contains__(self, key):
        return (dict.__contains__(self, key) or key in self.pager._cold
                or key in self.quant_specs)

    def copy(self):
        new = LazyEnv(self.pager, self.cs, self.make_table,
                      self.table_sizes, self.quant_specs)
        new.update(self)
        return new


def _chunked_table(name, arr, cs):
    return table_from_chunked(ChunkedTensor.from_dense(
        name, arr, chunk_size=min(cs, arr.shape[-1]), device=arr.device))


class RelationalEngine:
    """The paper's engine: two-stage-compiled pipelines over chunked tables.

    Takes the reference engine's parameters and defaults.  ``row2col``
    (``"off"`` / ``"auto"`` / ``"col"``) and ``cache_layout`` (``"off"`` /
    ``"auto"`` / a layout name) run the physical planner on every
    pipeline; prefill and batched plans are forced to the decode plan's
    cache layout, so every session cache, batched pool and prefix segment
    has one key order.  ``chunk_size="auto"`` picks the base chunk size
    with the planner's cost model over ``chunk_candidates`` and plans
    per-table chunk sizes; ``cost_params`` replaces the analytic cost
    weights.  ``precision`` (``"f32"`` / ``"auto"`` / ``"int8"`` /
    ``"nf4"``) and ``table_precisions`` make the stored payload format a
    planner decision; ``accuracy_budget`` runs the quant gate against an
    f32 engine at construction.  The planned column, re-chunked and
    quantised tables are built once on the device beside the row tables.

    ``residency="paged"`` (the paper's Disk+mem mode) keeps the weight
    tables in a :class:`~repro_torch.serving.pager.WeightPager` cold store
    (pinned host memory, or ``.npy`` files under ``disk_dir``) and pages
    them into a device working set bounded by ``budget_bytes`` under
    ``pager_policy`` (``"pin"``: MRU, or ``"clock"``).  The planner's
    column and quantised twins are converted once into the cold store, on
    the device one table at a time, and the planner prices its column
    copies against the budget (``precision="auto"`` quantises to fit it).
    ``shards`` is the reference's tensor-parallel planner axis: ``None``/1
    runs unsharded, ``"auto"`` one shard a host core (the planner clamps
    it), N > 1 splits the eligible matmul sites into N key-range slices
    that a :class:`~repro_torch.serving.shards.ShardWorkerPool` runs on N
    CUDA streams.

    ``device`` is where the weight tables, caches and every kernel live:
    the CUDA card unless the caller passes ``"cpu"``.  ``metrics`` is an
    optional ``repro_torch.obs.MetricsRegistry``: plan-cache lookups,
    single-sequence decode step latency, re-plans, quantised bytes and the
    pager here, decode ticks and the prefix cache in
    :class:`BatchedDecoder`, requests in the scheduler.  ``tracer`` is an
    optional ``repro_torch.obs.TraceRecorder``: one ``cat="plan"`` span a
    plan compile, ``session_env`` spans, the decoder's phase spans, and
    through ``run_pipeline`` one ``cat="step"`` span a pipeline step (each
    ending in a synchronise of the current stream, so leave it ``None``
    when timing end to end) with the executor's ``cat="op"`` spans; the
    pager and the shard workers record their own.
    """

    PRECISION_KNOBS = ("f32", "auto", "int8", "nf4")

    def __init__(self, spec: lg.LlamaSpec, params: Dict[str, object],
                 chunk_size=64, residency: str = "in_memory",
                 budget_bytes: Optional[int] = None,
                 disk_dir: Optional[str] = None, max_len: int = 1024,
                 pager_policy: str = "pin", row2col: str = "auto",
                 cache_layout: str = "auto",
                 chunk_candidates=None, cost_params=None,
                 precision: str = "f32",
                 table_precisions: Optional[Dict[str, str]] = None,
                 accuracy_budget: Optional[float] = None,
                 metrics=None, tracer=None, shards=None, device="cuda"):
        if row2col not in MODES:
            raise ValueError(f"row2col must be one of {MODES}, got "
                             f"{row2col!r}")
        if cache_layout not in CACHE_MODES:
            raise ValueError(f"cache_layout must be one of {CACHE_MODES}, "
                             f"got {cache_layout!r}")
        if precision not in self.PRECISION_KNOBS:
            raise ValueError(f"precision must be one of "
                             f"{self.PRECISION_KNOBS}, got {precision!r}")
        self.device = resolve_device(device)
        self._chunk_mode = "off"
        if chunk_size == "auto":
            from repro_torch.planner.calibrate import choose_base_chunk_size
            if row2col == "off":
                raise ValueError("chunk_size='auto' needs the layout "
                                 "planner (row2col 'auto' or 'col')")
            chunk_size = choose_base_chunk_size(
                spec, cache_len=max_len, candidates=chunk_candidates,
                params=cost_params)
            self._chunk_mode = "auto"
        self.spec = spec
        self.cs = int(chunk_size)
        self.max_len = max_len
        # zero-cost when None: every site guards with `is not None`
        self.metrics = metrics
        self.tracer = tracer
        # shards: None/1 keeps plans and execution identical to an
        # unsharded engine; "auto" sizes the worker pool to the host's
        # cores; N > 1 splits eligible matmul sites into N key-range shards
        if shards in (None, 0, 1):
            self.shards = 1
        elif shards == "auto":
            self.shards = max(1, os.cpu_count() or 1)
        else:
            self.shards = int(shards)
            if self.shards < 1:
                raise ValueError(f"shards must be >= 1, got {shards}")
        self.shard_pool = None
        self._shard_runner = None
        self.residency = residency
        self.row2col = row2col
        self.precision = precision
        self._precision_mode = "off" if precision == "f32" else precision
        self._table_precisions = dict(table_precisions or {})
        # quantised-table wrap specs shared by reference with the LazyEnv
        # (paged residency): q_table -> (precision, chunk_size, schema)
        self._quant_specs: Dict[str, tuple] = {}
        self._chunk_candidates = chunk_candidates
        self._cost_params = cost_params
        # paged residency: column copies compete with the working set, so
        # the planner's residency pass runs under the pager budget;
        # in-memory residency is unbounded.  One ResidencyPool is shared by
        # the decode and every prefill and batched plan: a column table one
        # plan committed is free for the others, and its chunk size and
        # precision are pinned
        self._residency_budget = (budget_bytes if residency != "in_memory"
                                  else None)
        self._residency_pool = ResidencyPool(self._residency_budget)
        # planner-chosen per-table chunk sizes, pinned for later plans;
        # shared by reference with the LazyEnv
        self._table_chunks: Dict[str, int] = {}
        # quantised-payload byte accounting for the metrics gauge (dedup
        # across the plans sharing q-tables)
        self._quant_bytes = 0
        self._quant_counted: set = set()
        self.replans = 0
        # prefill plans, keyed by (prompt length, suffix?): a suffix plan
        # takes the prefix boundary as the runtime :cache_position (the
        # append offset and the causal mask), so one plan per suffix
        # length serves every boundary
        self._prefill_pipes: Dict[tuple, object] = {}
        # batched decode plans, keyed by batch-size bucket — buckets are
        # powers of two: sessions join/leave the batch without replanning
        self._batched_pipes: Dict[int, object] = {}
        self.decode_pipe = self._compile_pipe(
            functools.partial(lg.build_decode_graph, spec, cache_len=max_len),
            cache_mode=cache_layout)
        self._table_chunks.update(self.decode_pipe.table_chunks)
        # resolved decode-time cache layout; prefill and batched plans are
        # forced to it (they share the session environments and the slot
        # pool with decode steps).  With the knob "off" the planner stays
        # off for their caches too and they keep the seed order.
        plan = self.decode_pipe.layout_plan
        self.cache_layout = (plan.cache_decisions[0].layout
                             if plan is not None and plan.cache_decisions
                             else "row_chunk")
        self._prefill_cache_mode = ("off" if cache_layout == "off"
                                    else self.cache_layout)
        if residency == "in_memory":
            self.env_base = lg.convert_weights(params, chunk_size=self.cs,
                                               device=self.device)
            self.pager = None
        else:
            self.pager = WeightPager(budget_bytes or 1 << 62,
                                     disk_dir=disk_dir, policy=pager_policy,
                                     metrics=metrics, tracer=tracer,
                                     device=self.device)
            for k, v in params.items():
                self.pager.add(k, v)
            self.env_base = LazyEnv(self.pager, self.cs, _chunked_table,
                                    table_sizes=self._table_chunks,
                                    quant_specs=self._quant_specs)
        self._register_layouts(self.decode_pipe)
        if self.shards > 1:
            from repro_torch.serving.shards import ShardWorkerPool
            self.shard_pool = ShardWorkerPool(
                self.shards, residency=residency, cs=self.cs,
                budget_bytes=self._residency_budget,
                pager_policy=pager_policy, trace=tracer is not None,
                device=self.device)
            self._shard_runner = self.shard_pool.run_step
        self._register_shards(self.decode_pipe)
        # the gate builds a full in-memory f32 reference engine (a second
        # weight copy and compile): an opt-in construction cost, skipped
        # when the plan quantised nothing
        if accuracy_budget is not None and self._precision_mode != "off" \
                and self.table_precision_choices:
            from repro_torch.quant.gate import check_accuracy
            ref = RelationalEngine(
                spec, params, chunk_size=self.cs, max_len=max_len,
                row2col=row2col, cache_layout=cache_layout,
                cost_params=cost_params, precision="f32",
                device=self.device)
            check_accuracy(self, ref, tolerance=accuracy_budget)

    def _compile_pipe(self, build, cache_mode: str):
        """Shared graph → planned-pipeline compile path.  Every pipeline
        the engine builds (decode, prefill, batched decode) comes through
        here so they plan under identical knobs: the shared residency
        pool, and (``chunk_size="auto"``) the decode plan's per-table chunk
        sizes pinned for every later plan.  Only the graph (``build()``
        makes it) and the cache mode (the seed decode plan resolves the
        knob; later plans are forced to its choice) differ per call site.

        With a tracer the whole compile, the graph's build included, is
        one ``compile:{graph}`` span (``cat="plan"``): a first-touch
        compile lands inside a serving tick (a new prefill length or batch
        bucket, a re-plan), where it would otherwise be unattributed tick
        time.  The compile then also derives the step spans' provenance
        (``step_span_args``), which walks every step's plan.  The span is
        recorded once the graph, and so its name, exists."""
        tracer = self.tracer
        if tracer is None:
            return self._compile_pipe_inner(build(), cache_mode)
        t0 = tracer._now_us()
        pipe = self._compile_pipe_inner(build(), cache_mode)
        step_span_args(pipe)
        tracer.add_span(f"compile:{pipe.name}", "plan", t0,
                        tracer._now_us() - t0, depth=tracer._depth)
        return pipe

    def _compile_pipe_inner(self, g, cache_mode: str):
        infer_shapes(g)
        preoptimize(g)
        pipe = op_map(g, chunk_size=self.cs)
        postoptimize(pipe, layout_mode=self.row2col,
                     cache_mode=cache_mode,
                     cost_params=self._cost_params,
                     chunk_mode=self._chunk_mode,
                     chunk_candidates=self._chunk_candidates,
                     table_chunks=(dict(self._table_chunks)
                                   if self._chunk_mode != "off" and
                                   self._table_chunks else None),
                     pool=self._residency_pool,
                     precision_mode=self._precision_mode,
                     table_precisions=self._table_precisions or None,
                     shards=self.shards if self.shards > 1 else None)
        return pipe

    def _register_layouts(self, pipe) -> None:
        """Make a pipeline's planned tables resolvable, once: built into
        the resident weights on the device (in-memory:
        ``LayoutPlan.ensure_env``), or converted into the pager's cold
        store (paged) — the offline ROW2COL and quantisation conversions,
        so paged accesses stay zero-copy wraps under the same working-set
        budget.  Records the pipeline's per-table chunk sizes and counts
        its quantised bytes for the metrics gauge."""
        self._table_chunks.update(getattr(pipe, "table_chunks", {}) or {})
        plan = getattr(pipe, "layout_plan", None)
        if plan is None:
            return
        if self.metrics is not None and plan.precision_decisions:
            for pd in plan.precision_decisions:
                if pd.q_table not in self._quant_counted:
                    self._quant_counted.add(pd.q_table)
                    self._quant_bytes += pd.q_bytes
            self.metrics.gauge(
                "engine_quantised_resident_bytes",
                "stored bytes of quantised weight tables").set(
                    self._quant_bytes)
        if self.pager is None:
            plan.ensure_env(self.env_base)
            return
        # paged: each conversion runs on the device, one table at a time,
        # and its result is copied back into the cold store (a transpose
        # is exact, and the codes on the card equal the CPU's).  Column
        # copies register padded to their chunk so the pager's byte
        # accounting matches the physical working set; head-blocked tables
        # transpose per head block ([H, dh, n] -> [H, n, dh])
        pager = self.pager
        for d in plan.col_decisions:
            if d.col_table in pager._cold:
                continue
            dense = pager.cold_tensor(d.table).to(self.device)
            dense = dense.transpose(1, 2) if d.is_head_site else dense.T
            pager.add(d.col_table, dense.contiguous(),
                      pad_to=d.physical_chunk)
            del dense
        # quantised payloads: each f32 source (row table, or the column
        # copy registered just above) becomes packed codes + scales in the
        # cold store; the paged working set then holds *quantised* bytes
        for pd in plan.precision_decisions:
            if pd.q_table in self._quant_specs:
                continue
            packed, scales = quantise_dense(
                pager.cold_tensor(pd.table).to(self.device), pd.chunk_size,
                CODECS[pd.precision])
            pager.add(pd.q_table + "::q", packed)
            pager.add(pd.q_table + "::scale", scales)
            self._quant_specs[pd.q_table] = (pd.precision, pd.chunk_size,
                                             pd.q_schema)

    def _register_shards(self, pipe) -> None:
        """Install a pipeline's shard-plan slices into the worker pool
        (no-op unsharded).  Ranges depend only on the key-domain size
        and N — identical across the decode/prefill/batched plans — so
        the pool dedupes by shard table name."""
        if self.shard_pool is None:
            return
        self.shard_pool.register_plan(
            getattr(pipe, "shard_plan", None), env_base=self.env_base,
            pager=self.pager, quant_specs=self._quant_specs,
            table_chunks=self._table_chunks, cs=self.cs)

    def merge_shard_metrics(self) -> None:
        """Fold each worker's private metrics registry into the engine
        registry under a ``shard`` label (call once at report time)."""
        if self.shard_pool is not None and self.metrics is not None:
            self.shard_pool.merge_metrics(self.metrics)

    def merged_shard_trace(self):
        """Chrome trace combining the coordinator's spans with every
        worker's, one pid per track (``None`` when the engine is
        unsharded; no events when tracing is off)."""
        if self.shard_pool is None:
            return None
        return self.shard_pool.merged_chrome_trace(self.tracer)

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
            pipe = self._compile_pipe(
                functools.partial(lg.build_prefill_graph, self.spec, T,
                                  cache_len=self.max_len, suffix=suffix),
                cache_mode=self._prefill_cache_mode)
            self._register_layouts(pipe)
            self._register_shards(pipe)
            self._prefill_pipes[key] = pipe
        return self._prefill_pipes[key]

    def _batched_decode_pipe(self, batch: int):
        """Compile (once per batch-size bucket) the seq-keyed decode plan
        that advances ``batch`` sequences in ONE ``run_pipeline`` call."""
        self._plan_cache_event("batched_decode", batch in self._batched_pipes)
        if batch not in self._batched_pipes:
            pipe = self._compile_pipe(
                functools.partial(lg.build_decode_graph, self.spec,
                                  cache_len=self.max_len, batch=batch),
                cache_mode=self._prefill_cache_mode)
            self._register_layouts(pipe)
            self._register_shards(pipe)
            self._batched_pipes[batch] = pipe
        return self._batched_pipes[batch]

    @staticmethod
    def _decode_bucket(batch: int) -> int:
        """Batch-size bucket (next power of two) a tick's plan is keyed by."""
        b = 1
        while b < batch:
            b *= 2
        return b

    def _weights_env(self):
        if self.pager is None:
            return dict(self.env_base)
        # .copy() keeps the LazyEnv and its shared table_sizes reference,
        # so sessions wrap cold tables at the planner's chunk sizes
        return self.env_base.copy()

    def _fresh_env(self):
        env = self._weights_env()
        env.update(lg.empty_cache_tables(self.spec, cache_len=self.max_len,
                                         chunk_size=self.cs,
                                         layout=self.cache_layout,
                                         device=self.device))
        return env

    def _final_logits(self, out_table) -> np.ndarray:
        """Final-position logits row (un-padded vocab), copied to the host."""
        v = out_table.cols["v"]
        return v.reshape(v.shape[0], -1)[-1, : self.spec.vocab].cpu().numpy()

    @property
    def table_precision_choices(self) -> Dict[str, str]:
        """Planner-chosen payload precision per stored weight table (the
        decode plan's decisions; tables absent here store f32)."""
        plan = getattr(self.decode_pipe, "layout_plan", None)
        if plan is None:
            return {}
        return {d.table: d.precision for d in plan.precision_decisions}

    def replan(self, cost_params) -> None:
        """Re-run physical planning under new cost weights and drop the
        compiled plan caches.  Call between scheduler ticks only.  What
        live sessions depend on stays pinned: the cache layout (the
        recompile is forced to the resolved layout), the per-table chunk
        sizes (``self._table_chunks`` and the shared pool) and the payload
        precisions (the pool pins every decided table), so the tokens do
        not change; only access paths (row or column) may."""
        from repro_torch.obs.log import log_event
        self._cost_params = cost_params
        for t, p in self.table_precision_choices.items():
            self._table_precisions.setdefault(t, p)
        pipe = self._compile_pipe(
            functools.partial(lg.build_decode_graph, self.spec,
                              cache_len=self.max_len),
            cache_mode=self._prefill_cache_mode)
        self._register_layouts(pipe)
        self._register_shards(pipe)
        self.decode_pipe = pipe
        self._prefill_pipes.clear()
        self._batched_pipes.clear()
        self.replans += 1
        if self.metrics is not None:
            self.metrics.counter(
                "engine_replans_total",
                "mid-flight re-planning events (drift watchdog)").inc()
        log_event("engine_replan", replans=self.replans,
                  group_weight=getattr(cost_params, "group_weight", None))

    # -- incremental session API ---------------------------------------------

    def start_session(self, prompt: List[int]):
        """Prefill; returns a session dict holding env + cursor + first tok."""
        T = len(prompt)
        with self._span("session_env"):
            env = self._fresh_env()
            env["token_ids"] = lg.token_table(np.asarray(prompt),
                                              device=self.device)
            env["freq_each_token"] = lg.rope_freq_table(
                np.arange(T), self.spec.head_dim, self.spec.rope_theta,
                device=self.device)
        if self.pager is not None:
            self.pager.prefetch(["vocabulary"])
        outs, env = run_pipeline(self._prefill_pipe(T), env,
                                 scalars={"cache_position": 0},
                                 tracer=self.tracer,
                                 shard_runner=self._shard_runner)
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
        with self._span("session_env"):
            env = self._weights_env()
            env.update(cache_tables)
            env["token_ids"] = lg.token_table(
                np.asarray(prompt[boundary:]), device=self.device)
            env["freq_each_token"] = lg.rope_freq_table(
                np.arange(boundary, len(prompt)), self.spec.head_dim,
                self.spec.rope_theta, device=self.device)
        if self.pager is not None:
            self.pager.prefetch(["vocabulary"])
        outs, env = run_pipeline(self._prefill_pipe(T, suffix=True), env,
                                 scalars={"cache_position": boundary},
                                 tracer=self.tracer,
                                 shard_runner=self._shard_runner)
        logits = self._final_logits(outs["logits"])
        return {"env": env, "pos": len(prompt),
                "tok": int(np.argmax(logits)), "logits": logits}

    def _span(self, name: str, **args):
        """Named ``cat="decoder"`` span (no-op without a tracer): work
        outside ``run_pipeline`` (session set-up, slot writes, the prefix
        cache) that would otherwise be unattributed tick time in the
        flight recorder."""
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(name, cat="decoder", **args)

    def prefill_logits(self, prompt: List[int]) -> np.ndarray:
        """Final-position prefill logits (the accuracy gate's probe)."""
        return self.start_session(list(prompt))["logits"]

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
                                 scalars={"cache_position": pos},
                                 tracer=self.tracer,
                                 shard_runner=self._shard_runner)
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
        if self.pager is not None:
            return GenerationResult(tokens, ttft, tpot,
                                    self.pager.stats.peak_bytes,
                                    dataclasses.asdict(self.pager.stats))
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
        engine's paged residency budget when one is set)."""
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
                                       engine.cs, layout=engine.cache_layout,
                                       device=engine.device)
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
        with self.engine._span("cache_fill"):
            self.pool.write_prefill(seq_id, sess["env"], len(prompt))
            tok = sess["tok"]
            del sess  # the session's step outputs go with the fill
        return tok

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
        span = self.engine._span
        with span("prefix_lookup"):
            hit = pc.lookup(prompt)
        if hit is None:
            sess = self.engine.start_session(prompt)
            with span("cache_fill"):
                self.pool.write_prefill(seq_id, sess["env"], len(prompt))
                pc.insert(prompt, sess["env"])
                tok = sess["tok"]
                del sess  # the session's step outputs go with the fill
            return tok, 0
        seg, boundary = hit
        sess = self.engine.start_suffix_session(prompt, boundary,
                                                seg.tables)
        with span("cache_fill", prefix_hit=boundary):
            if self._resolve_bind(boundary) == "share":
                # the slot holds only the divergent suffix; gathers splice
                # the segment's rows in (UNION-remap); the segment stays
                # pinned
                pc.acquire(seg)
                self.pool.write_suffix(seq_id, sess["env"], len(prompt),
                                       boundary)
                self.pool.bind_segment(seq_id, seg, boundary)
            else:
                # bulk copy (INSERT ... SELECT): the slot owns a private
                # full copy, no pin, no gather-time splice
                self.pool.write_prefill(seq_id, sess["env"], len(prompt))
            # intern the extended prefix too (no-op if coverage unchanged)
            pc.insert(prompt, sess["env"])
            tok = sess["tok"]
            del sess
        return tok, boundary

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
        # decoder-phase spans name the tick's work outside run_pipeline
        # (view gathers, cache writeback, logits extraction), so a
        # flight-recorded tick attributes its wall time end to end
        span = eng._span
        t0 = time.perf_counter() if metrics is not None else 0.0
        B = len(seq_ids)
        bucket = eng._decode_bucket(B)
        ids = list(seq_ids) + [seq_ids[-1]] * (bucket - B)
        toks = list(last_tokens) + [last_tokens[-1]] * (bucket - B)
        pipe = eng._batched_decode_pipe(bucket)
        positions = self.pool.positions[np.asarray(ids)]
        view_key = (tuple(ids), self.pool.slot_generations(ids))
        view_hit = self._view_key == view_key
        with span("cache_views", outcome="hit" if view_hit else "miss"):
            env = eng._weights_env()
            if view_hit:
                env.update(self._views)  # unchanged batch: reuse last views
            else:
                env.update(self.pool.gather_views(ids))
            env["token_ids"] = lg.token_table(np.asarray(toks), key="seq",
                                              device=eng.device)
            env["freq_each_token"] = lg.rope_freq_table(
                positions, eng.spec.head_dim, eng.spec.rope_theta,
                key="seq", device=eng.device)
        if metrics is not None:
            metrics.counter("decoder_view_cache_total",
                            "batched cache-view gathers",
                            outcome="hit" if view_hit else "miss").inc()
        outs, env = run_pipeline(pipe, env,
                                 scalars={"seq_positions": positions},
                                 tracer=eng.tracer,
                                 shard_runner=eng._shard_runner)
        self.decode_calls += 1
        # the tick's only cache mutation is one appended row per sequence
        # at positions[b] — write back just those rows; the updated views
        # (which already contain them) serve the next tick's gather
        with span("cache_writeback"):
            self.pool.scatter_rows(ids, env, positions)
            self._views = {name: env[name] for name in self.pool.tables}
            self._view_key = view_key
            for s in seq_ids:
                self.pool.positions[s] += 1
            # the tick's step outputs go here, where they were last read
            # (freeing a few thousand tensors takes milliseconds)
            del env
        with span("logits_argmax"):
            logits = outs["logits"].cols["v"].reshape(bucket, -1)[
                :B, : eng.spec.vocab].cpu().numpy()
            next_toks = [int(t) for t in np.argmax(logits, axis=1)]
            del outs
        if metrics is not None:
            metrics.histogram(
                "decoder_tick_seconds",
                "batched decode tick latency").observe(
                    time.perf_counter() - t0)
            metrics.gauge("decoder_bucket_occupancy",
                          "live sequences / padded bucket size").set(
                              B / bucket)
        return next_toks
