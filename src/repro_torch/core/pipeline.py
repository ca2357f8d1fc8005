"""Pipeline runner: executes a compiled relational pipeline on the tensor
executor (bind steps) with KV-cache INSERT semantics (append steps).

``run_pipeline`` leaves the caller's ``env`` untouched, as the reference
does: cache tables are returned updated in a new environment.  The append
is out of place — the cache tensor is cloned, then the new rows are
written into the clone — so a caller that keeps last tick's tables (the
batched decoder's view cache) still holds them unchanged.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.executor import (DenseTable, execute,
                                        steps_provenance)
from repro_torch.core.opmap import RelPipeline


def _bind_scalars(scalars, device):
    """Split runtime parameters into host values (for bounds checks) and
    executor values: Python ints for scalars, int64 tensors on ``device``
    for per-key vectors (converted once per call, not per use)."""
    host, dev = {}, {}
    for name, v in scalars.items():
        arr = np.asarray(v)
        if arr.ndim == 0:
            host[name] = dev[name] = int(arr)
        else:
            host[name] = arr.astype(np.int64)
            dev[name] = torch.from_numpy(host[name]).to(device)
    return host, dev


def step_span_args(pipeline: RelPipeline):
    """The ``(ops, tables)`` lists each step span of ``pipeline`` carries
    (the op classes and tables of the step's plan), computed once a
    pipeline and shared by its spans (no span mutates its args).  The
    engine calls it inside a traced plan compile, so a serving tick does
    not pay for it."""
    args = getattr(pipeline, "_step_span_args", None)
    if args is None:
        args = [(list(ops), list(tables)) for ops, tables in
                steps_provenance(s.rel.plan for s in pipeline.steps)]
        pipeline._step_span_args = args
    return args


def run_pipeline(
    pipeline: RelPipeline,
    env: Dict[str, DenseTable],
    scalars: Optional[Dict] = None,
    layout_plan=None,
    tracer=None,
    shard_runner=None,
) -> Tuple[Dict[str, DenseTable], Dict[str, DenseTable]]:
    """Execute all steps. Returns (outputs, updated_env).

    ``scalars`` supplies append offsets (``cache_position``, an int, or
    ``seq_positions``, one int per sequence) so the same compiled pipeline
    serves every decode step.  An append that would write past the end of
    its cache table raises ``IndexError`` (the reference clamps the start
    of the write or drops it).

    If the pipeline was layout-planned (``repro_torch.planner.
    plan_layouts``), the plan's COL_CHUNK / COL_CHUNK_HEADS tables,
    re-chunked ROW_CHUNK tables and quantised twins are materialised on
    the environment's device into this call's copy of ``env`` wherever the
    caller has not registered them (``LayoutPlan.ensure_env``), and cache
    tables are aligned to the planned key order; pass ``layout_plan`` to
    override the plan recorded on the pipeline.

    ``shard_runner`` (e.g. ``repro_torch.serving.shards.ShardWorkerPool.
    run_step``) takes over bind steps the pipeline's shard plan split
    across workers: it fans the per-shard plan copies out, combines the
    partials, seeds this call's memo at the sharded aggregates and
    executes the step's unsharded tail, returning the step's output
    table.  Steps without shard decisions (and all append steps) run on
    the normal path regardless.

    ``env`` may be a paged ``LazyEnv`` (``serving/engine.py``), which
    fetches weight tables on first Scan; it is copied with ``.copy()`` so
    it stays one, and it names the device the call runs on.

    ``tracer`` (an ``Optional[repro_torch.obs.trace.TraceRecorder]``)
    records one ``cat="step"`` span per pipeline step, named after the
    step with its ``kind`` and the op classes and tables of its plan
    (``plan_provenance``), plus the executor's per-node ``cat="op"``
    spans; the shard runner gets it too.  A step span ends in a
    synchronise of the calling thread's current stream, so it measures the
    step's device work, not its dispatch; the other streams (the pager's
    copies, the shard workers') are not waited on.  On the CPU the work
    is done on return.  With ``tracer=None`` the only cost is one
    ``None`` check a step.
    """
    env = env.copy()
    layout_plan = layout_plan or getattr(pipeline, "layout_plan", None)
    if layout_plan is not None:
        env = layout_plan.ensure_env(env)
    shard_plan = (getattr(pipeline, "shard_plan", None)
                  if shard_runner is not None else None)
    device = getattr(env, "device", None) or next(
        iter(next(iter(env.values())).cols.values())).device
    host, scalars = _bind_scalars(scalars or {}, device)
    memo: Dict[int, DenseTable] = {}
    stream = (torch.cuda.current_stream(device)
              if tracer is not None and device.type == "cuda" else None)

    def run_step(step) -> None:
        if step.kind == "bind":
            if shard_plan is not None and step.name in shard_plan.by_step:
                env[step.name] = shard_runner(shard_plan, step, env, memo,
                                              scalars, tracer)
            else:
                env[step.name] = execute(step.rel.plan, env, memo, scalars,
                                         tracer)
        elif step.kind == "append":
            env[step.name] = _append(step, env, memo, host, scalars, device,
                                     tracer)
        else:
            raise ValueError(step.kind)

    if tracer is None:
        for step in pipeline.steps:
            run_step(step)
    else:
        for step, (ops, tables) in zip(pipeline.steps,
                                       step_span_args(pipeline)):
            with tracer.span(step.name, cat="step", kind=step.kind,
                             ops=ops, tables=tables):
                run_step(step)
                if stream is not None:
                    stream.synchronize()

    outputs = {o: env[o] for o in pipeline.outputs}
    return outputs, env


def _append(step, env, memo, host, scalars, device, tracer) -> DenseTable:
    """An append step: the new rows written into a clone of the cache
    table at the step's offset (one per sequence when batched)."""
    new = execute(step.rel.plan, env, memo, scalars, tracer)
    cache = env[step.name]
    ax = cache.key_names.index(step.append_key)
    cache_len = cache.keys[ax][1]
    cols = {}
    if step.seq_key is not None:
        # batched append: the new relation has one row per sequence and
        # no position key; each sequence's row is written at (seq,
        # offset[seq]) — a per-sequence INSERT position — in ONE
        # indexed write over (seq, append) brought to the front
        sax = cache.key_names.index(step.seq_key)
        nseq = cache.keys[sax][1]
        offsets = host[step.offset_name].reshape(-1)
        if offsets.shape != (nseq,) or offsets.min() < 0 \
                or offsets.max() >= cache_len:
            raise IndexError(
                f"{step.name}: per-sequence append positions {offsets} "
                f"must be {nseq} values in [0, {cache_len})")
        order = [k for k in cache.key_names if k != step.append_key]
        perm = [new.key_names.index(k) for k in order]
        sax_new = order.index(step.seq_key)
        for cname, arr in cache.cols.items():
            new_arr = new.cols[cname]
            vec = new_arr.ndim > len(perm)
            new_arr = new_arr.permute(*perm, *([len(perm)] if vec else []))
            out = arr.clone()
            out.movedim((sax, ax), (0, 1))[
                torch.arange(nseq, device=device),
                scalars[step.offset_name]] = torch.movedim(
                    new_arr, sax_new, 0).to(arr.dtype)
            cols[cname] = out
    else:
        # the cache table's physical key order may differ from the new
        # rows'; align the new rows' axes by key name and insert at the
        # append key's axis
        offset = host.get(step.offset_name, 0)
        perm = [new.key_names.index(k) for k in cache.key_names]
        for cname, arr in cache.cols.items():
            new_arr = new.cols[cname]
            vec = new_arr.ndim > len(perm)
            new_arr = new_arr.permute(*perm, *([len(perm)] if vec else []))
            n = new_arr.shape[ax]
            if not 0 <= offset <= cache_len - n:
                raise IndexError(
                    f"{step.name}: appending {n} rows at position "
                    f"{offset} overflows the cache ({cache_len} rows)")
            out = arr.clone()
            out.narrow(ax, offset, n).copy_(new_arr)
            cols[cname] = out
    return DenseTable(keys=cache.keys, cols=cols, col_types=cache.col_types)
