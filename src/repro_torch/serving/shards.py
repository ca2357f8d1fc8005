"""Sharded execution worker pool — the serving half of the planner's
tensor-parallel axis (``repro_torch.planner.shard``).

The planner records, per eligible matmul site, N per-shard plan copies
whose Scans read contiguous key-range slices ``{table}::shard{s}`` of the
stored weight table.  This module owns the runtime:

* :class:`ShardWorker` — one shard's private execution state: the shard
  slices of every sharded weight table (views of the resident tables
  in-memory, or its own :class:`~repro_torch.serving.pager.WeightPager` +
  ``LazyEnv`` over sliced cold arrays under a split ``budget_bytes // N``
  working-set budget when paged), a private ``MetricsRegistry``, and on a
  CUDA device a stream of its own.
* :class:`ShardWorkerPool` — fan-out/fan-in: ``run_step`` is the
  ``shard_runner`` hook :func:`repro_torch.core.pipeline.run_pipeline`
  calls for bind steps with shard decisions.  For each site it executes
  the shared left (activation) subtree ONCE on the coordinator, slices it
  along the reduction key for row-parallel sites, runs the per-shard plan
  copies concurrently on a thread pool, combines the partials (SUM of
  partial sums in shard order / concatenation along the shard key), seeds
  the coordinator's memo at the site's GroupAgg, and runs the step's
  unsharded tail exactly once on top.

On the card each worker issues its plan copy on its own CUDA stream: it
waits on an event the coordinator records after the shared left subtree,
and records one when its partial is done; the coordinator's stream waits
on every worker's event before it combines.  A tensor read on a stream
other than the one that allocated it gets ``record_stream`` for that
stream (the left activation for the worker's, each partial for the
coordinator's).  The threads launch on their streams concurrently: the
kernel wrappers release the interpreter lock in their ``ctypes`` calls.

A slice is a ``narrow`` view, never a copy: K1 takes any row stride with
a unit inner stride, so a row-parallel shard's launch reads W's rows at
the full table's stride.

Worker-side state is installed by :meth:`ShardWorkerPool.register_plan`
— called once per compiled pipeline (decode, each prefill length, each
batched-decode bucket); shard tables are deduplicated by name, so plans
sharing a weight table share its slices.

Busy-time accounting: the pool tracks, per fan-out, the summed and the
critical-path (max) worker busy time, each worker's ending in a
synchronise on its event.  ``projected_saving_s`` (sum − max) is what a
perfectly parallel run removes from serialised fan-out.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import torch

from repro_torch.core.chunked import resolve_device
from repro_torch.core.executor import DenseTable, execute
from repro_torch.core.relational import Scan, is_vec, vec_width
from repro_torch.obs.context import activate, current_context
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import TraceRecorder
from repro_torch.planner.shard import (COMBINE_SUM, ShardDecision, ShardPlan,
                                       _slice_schema)
from repro_torch.serving.engine import LazyEnv, _chunked_table
from repro_torch.serving.pager import WeightPager


def slice_table(t: DenseTable, key: str, lo: int, hi: int) -> DenseTable:
    """Contiguous key-range slice of a DenseTable along a named key, as
    views.

    Columns are broadcast to their full key shape first (Join outputs
    keep lazily-broadcast columns), so the slice is positionally exact
    for every column.
    """
    ax = t.key_names.index(key)
    cols = {}
    for c, arr in t.cols.items():
        vec = is_vec(t.col_types[c])
        full = t.key_sizes + ((arr.shape[-1],) if vec else ())
        if tuple(arr.shape) != full:
            arr = torch.broadcast_to(arr, full)
        cols[c] = arr.narrow(ax, lo, hi - lo)
    keys = tuple((k, hi - lo if k == key else s) for k, s in t.keys)
    return DenseTable(keys=keys, cols=cols, col_types=dict(t.col_types))


def _schema_payload_width(schema) -> int:
    """Physical chunk width of a stored table's vector payload column."""
    for _, ctype in schema.cols:
        if is_vec(ctype):
            return vec_width(ctype)
    return 0


def _record(table: DenseTable, stream) -> None:
    """Keep a table's device tensors from reuse until ``stream`` has read
    them (no-op on the CPU)."""
    if stream is None:
        return
    for arr in table.cols.values():
        if arr.is_cuda:
            arr.record_stream(stream)


@dataclasses.dataclass
class ShardPoolStats:
    """Fan-out accounting across every sharded site executed so far."""

    sites: int = 0             # sharded sites fanned out
    fanout_s: float = 0.0      # summed worker busy seconds
    critical_s: float = 0.0    # per-site max (critical path) busy seconds

    @property
    def projected_saving_s(self) -> float:
        """Wall-clock seconds a perfectly parallel run removes relative
        to serialised fan-out (sum − critical path)."""
        return self.fanout_s - self.critical_s


class ShardWorker:
    """One shard's private execution state."""

    def __init__(self, index: int, residency: str, cs: int,
                 budget_bytes: Optional[int] = None,
                 pager_policy: str = "pin", trace: bool = False,
                 device="cuda"):
        self.index = index
        self.residency = residency
        self.device = resolve_device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self.metrics = MetricsRegistry()
        self.tracer = TraceRecorder() if trace else None
        if residency == "in_memory":
            self.pager = None
            self.env: Dict[str, DenseTable] = {}
        else:
            self.pager = WeightPager(budget_bytes or 1 << 62,
                                     policy=pager_policy,
                                     metrics=self.metrics,
                                     device=self.device)
            self._table_sizes: Dict[str, int] = {}
            self._quant_specs: Dict[str, tuple] = {}
            self.env = LazyEnv(self.pager, cs, _chunked_table,
                               table_sizes=self._table_sizes,
                               quant_specs=self._quant_specs)

    # -- shard-table installation -------------------------------------------

    def install_memory(self, name: str, base: DenseTable, axis_pos: int,
                       lo: int, hi: int) -> None:
        """In-memory residency: a zero-copy slice of the resident base
        table along the shard axis (f32 chunked tables and quantised
        code/scale tables alike)."""
        cols = {c: arr.narrow(axis_pos, lo, hi - lo)
                for c, arr in base.cols.items()}
        keys = tuple((k, hi - lo if i == axis_pos else s)
                     for i, (k, s) in enumerate(base.keys))
        self.env[name] = DenseTable(keys=keys, cols=cols,
                                    col_types=dict(base.col_types))

    def install_paged(self, name: str, cold, axis_pos: int, n_keys: int,
                      pcs: int, lo: int, hi: int) -> None:
        """Paged residency: register the cold-store slice under this
        worker's own pager.  f32 cold arrays fold the trailing chunk key
        into the payload axis (``ndim == n_keys``), so a trailing-key
        shard slices ``pcs``-wide elements; leading keys slice directly.
        ``pad_to`` re-pads a short final shard of an unpadded table."""
        if axis_pos == n_keys - 1:
            self.pager.add(name, cold[..., lo * pcs: hi * pcs], pad_to=pcs)
        else:
            self.pager.add(
                name, cold[(slice(None),) * axis_pos + (slice(lo, hi),)])
        self._table_sizes[name] = pcs

    def install_paged_quant(self, name: str, packed, scales, spec: tuple,
                            local_schema) -> None:
        """Paged quantised table: register pre-sliced packed codes and
        per-group scales (sliced along the real, unfolded shard key
        axis) under this worker's pager; the slice-sized schema makes
        the LazyEnv wrap shape-check pass per shard."""
        self.pager.add(name + "::q", packed)
        self.pager.add(name + "::scale", scales)
        precision, chunk_size, _ = spec
        self._quant_specs[name] = (precision, chunk_size, local_schema)

    # -- execution ----------------------------------------------------------

    def run(self, dec: ShardDecision, s: int, left: DenseTable, scalars,
            ready=None, ctx=None) -> tuple:
        """Execute this worker's plan copy for one site; returns
        ``(partial_table, busy_seconds, done_event)`` (no event on the
        CPU).  The left activation arrives pre-computed (and, for row
        sites, pre-sliced) from the coordinator, whose stream recorded
        ``ready`` after computing it: it is seeded into the worker's
        environment when the plan's left is a Scan (the executor's Scan
        branch reads the environment, never the memo) and into the memo
        otherwise.  ``ctx`` is the coordinator's trace context:
        contextvars do not cross the thread-pool boundary, so the pool
        captures it at fan-out and this method re-activates it: the
        worker's spans then carry the coordinator's request ids.

        With ``trace`` on, the plan copy's dispatch runs under one
        ``cat="shard"`` span ``"{step}::shard{s}"`` in the worker's own
        recorder, a step span of the worker's stream: its ``device_us``
        is read once the worker has waited for its ``done`` event (its own
        stream, not the device: the other workers' streams run on)."""
        t0 = time.perf_counter()
        env = self.env.copy()
        memo: Dict[int, DenseTable] = {}
        if isinstance(dec.left, Scan):
            env[dec.left.table] = left
        else:
            memo[id(dec.left)] = left
        done = None
        on_stream = (torch.cuda.stream(self.stream) if self.stream is not None
                     else contextlib.nullcontext())
        with activate(ctx), on_stream:
            if self.stream is not None:
                self.stream.wait_event(ready)
                _record(left, self.stream)
            span = (contextlib.nullcontext() if self.tracer is None
                    else self.tracer.device_span(
                        f"{dec.step_name}::shard{s}", "shard", self.stream,
                        table=dec.table, kind=dec.kind,
                        combine=dec.combine))
            with span:
                out = execute(dec.shard_roots[s], env, memo, scalars)
            if self.stream is not None:
                done = torch.cuda.Event()
                done.record(self.stream)
                done.synchronize()
            if self.tracer is not None:
                self.tracer.resolve_device()
        busy = time.perf_counter() - t0
        self.metrics.counter("shard_worker_runs_total",
                             "per-shard plan executions").inc()
        self.metrics.histogram("shard_worker_busy_seconds",
                               "per-shard plan execution time").observe(busy)
        return out, busy, done


class ShardWorkerPool:
    """Concurrent fan-out over :class:`ShardWorker`\\ s.

    ``run_step`` implements the ``shard_runner`` contract of
    :func:`repro_torch.core.pipeline.run_pipeline`.
    """

    def __init__(self, n_shards: int, residency: str = "in_memory",
                 cs: int = 64, budget_bytes: Optional[int] = None,
                 pager_policy: str = "pin", trace: bool = False,
                 device="cuda"):
        if n_shards < 2:
            raise ValueError("ShardWorkerPool needs n_shards >= 2")
        self.n = int(n_shards)
        self.device = resolve_device(device)
        # split working-set budget: each worker pages its slices under
        # an equal share of the engine budget
        per_worker = (budget_bytes // self.n) if budget_bytes else None
        self.workers = [
            ShardWorker(s, residency, cs, budget_bytes=per_worker,
                        pager_policy=pager_policy, trace=trace,
                        device=self.device)
            for s in range(self.n)
        ]
        self._exec = ThreadPoolExecutor(max_workers=self.n,
                                        thread_name_prefix="shard")
        self._registered: set = set()
        self._reg_lock = threading.Lock()
        self.stats = ShardPoolStats()

    # -- registration --------------------------------------------------------

    def register_plan(self, shard_plan: Optional[ShardPlan],
                      env_base=None, pager: Optional[WeightPager] = None,
                      quant_specs: Optional[Dict[str, tuple]] = None,
                      table_chunks: Optional[Dict[str, int]] = None,
                      cs: int = 64) -> None:
        """Install every decision's shard tables into the workers.

        In-memory residency slices the resident base tables from
        ``env_base``; paged residency slices the coordinator pager's
        cold arrays into each worker's own pager (quantised tables slice
        their packed-code and scale entries).  Tables already installed
        (an earlier pipeline sharded them — ranges depend only on the
        key-domain size and N, so they are identical) are skipped.
        """
        if shard_plan is None:
            return
        quant_specs = quant_specs or {}
        table_chunks = table_chunks or {}
        with self._reg_lock:
            for dec in shard_plan.decisions:
                if dec.table in self._registered:
                    continue
                self._registered.add(dec.table)
                schema = dec.scan.table_schema
                ax = schema.key_names.index(dec.axis)
                if self.workers[0].residency == "in_memory":
                    base = env_base[dec.table]
                    for s, (lo, hi) in enumerate(dec.ranges):
                        self.workers[s].install_memory(
                            dec.shard_table(s), base, ax, lo, hi)
                    continue
                spec = quant_specs.get(dec.table)
                if spec is not None:
                    packed = pager._cold[dec.table + "::q"]
                    scales = pager._cold[dec.table + "::scale"]
                    for s, (lo, hi) in enumerate(dec.ranges):
                        sl = (slice(None),) * ax + (slice(lo, hi),)
                        local = _slice_schema(spec[2], dec.axis, lo, hi)
                        self.workers[s].install_paged_quant(
                            dec.shard_table(s), packed[sl], scales[sl],
                            spec, local)
                    continue
                cold = pager._cold[dec.table]
                pcs = (table_chunks.get(dec.table)
                       or _schema_payload_width(schema) or cs)
                for s, (lo, hi) in enumerate(dec.ranges):
                    self.workers[s].install_paged(
                        dec.shard_table(s), cold, ax, len(schema.keys),
                        pcs, lo, hi)

    # -- the shard_runner hook ----------------------------------------------

    def run_step(self, shard_plan: ShardPlan, step, env, memo, scalars,
                 tracer=None) -> DenseTable:
        """Fan one bind step's sharded sites out and run its tail.

        Decisions arrive inner-first (planner post-order), so a site
        nested inside another site's activation subtree is combined —
        and memo-seeded — before the outer site's left executes.  The
        coordinator's work (each site's left subtree and the step's tail)
        gets ``tracer``'s op spans; the workers record into their own."""
        cuda = self.device.type == "cuda"
        # contextvars do not propagate into ThreadPoolExecutor workers,
        # so each worker re-activates the coordinator's (ShardWorker.run)
        ctx = current_context()
        for dec in shard_plan.by_step[step.name]:
            left = execute(dec.left, env, memo, scalars, tracer)
            ready = None
            if cuda:
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(self.device))
            jobs = []
            for s, (lo, hi) in enumerate(dec.ranges):
                left_s = left
                if dec.combine == COMBINE_SUM:
                    left_s = slice_table(left, dec.left_key, lo, hi)
                jobs.append((s, left_s))
            futures = [self._exec.submit(
                self.workers[s].run, dec, s, left_s, scalars, ready=ready,
                ctx=ctx) for s, left_s in jobs]
            results = [f.result() for f in futures]
            partials = [r[0] for r in results]
            if cuda:
                stream = torch.cuda.current_stream(self.device)
                for part, _, done in results:
                    stream.wait_event(done)
                    _record(part, stream)
            busy = [r[1] for r in results]
            self.stats.sites += 1
            self.stats.fanout_s += sum(busy)
            self.stats.critical_s += max(busy)
            memo[id(dec.agg)] = self._combine(dec, partials)
        return execute(step.rel.plan, env, memo, scalars, tracer)

    @staticmethod
    def _combine(dec: ShardDecision, partials: List[DenseTable]
                 ) -> DenseTable:
        """SUM of partial sums (row sites), added in shard order so the
        result does not depend on which worker finished first, or
        concatenation along the shard key (col/head sites).  Shard ranges
        are contiguous and ascending, so concatenation order is shard
        order."""
        first = partials[0]
        if dec.combine == COMBINE_SUM:
            cols = {}
            for c in first.cols:
                acc = partials[0].cols[c]
                for p in partials[1:]:
                    acc = acc + p.cols[c]
                cols[c] = acc
            return DenseTable(keys=first.keys, cols=cols,
                              col_types=dict(first.col_types))
        ax = first.key_names.index(dec.axis)
        cols = {c: torch.cat([p.cols[c] for p in partials], dim=ax)
                for c in first.cols}
        keys = tuple(
            (k, sum(p.keys[i][1] for p in partials) if i == ax else sz)
            for i, (k, sz) in enumerate(first.keys))
        return DenseTable(keys=keys, cols=cols,
                          col_types=dict(first.col_types))

    # -- observability -------------------------------------------------------

    def merge_metrics(self, registry) -> None:
        """Fold every worker's private registry into ``registry`` with a
        ``shard`` label."""
        if registry is None:
            return
        for w in self.workers:
            registry.merge(w.metrics, shard=str(w.index))

    def merged_chrome_trace(self, main_tracer=None) -> Dict:
        """One Chrome trace with the coordinator on pid 1 and each
        worker's spans on their own pid, re-based to a common epoch so
        fan-out renders as overlapping tracks."""
        recs = []
        if main_tracer is not None:
            recs.append(("coordinator", main_tracer))
        recs.extend((f"shard{w.index}", w.tracer)
                    for w in self.workers if w.tracer is not None)
        if not recs:
            return {"displayTimeUnit": "ms", "traceEvents": []}
        epoch0 = min(r._epoch for _, r in recs)
        events = []
        for pid, (track, rec) in enumerate(recs, start=1):
            off_us = (rec._epoch - epoch0) * 1e6
            for e in rec.events:
                events.append({
                    "name": e.name, "cat": e.cat or "default", "ph": "X",
                    "ts": e.ts_us + off_us, "dur": e.dur_us, "pid": pid,
                    "tid": e.depth,
                    "args": dict(e.args, track=track),
                })
        events.sort(key=lambda e: e["ts"])
        return {"displayTimeUnit": "ms", "traceEvents": events}

    def shutdown(self) -> None:
        self._exec.shutdown(wait=False)
