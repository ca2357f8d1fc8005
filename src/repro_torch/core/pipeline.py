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

from repro_torch.core.executor import DenseTable, execute
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

    ``tracer`` and ``shard_runner`` keep the reference's signature;
    tracing and shards are not ported, so anything but ``None`` raises
    ``NotImplementedError``.
    """
    if tracer is not None:
        raise NotImplementedError(
            "pipeline tracing is not ported: see ROADMAP.md next slice N6")
    if shard_runner is not None:
        raise NotImplementedError(
            "sharded execution is not ported: see ROADMAP.md next slice N7")
    env = dict(env)
    layout_plan = layout_plan or getattr(pipeline, "layout_plan", None)
    if layout_plan is not None:
        env = layout_plan.ensure_env(env)
    device = next(iter(next(iter(env.values())).cols.values())).device
    host, scalars = _bind_scalars(scalars or {}, device)
    memo: Dict[int, DenseTable] = {}

    for step in pipeline.steps:
        if step.kind == "bind":
            env[step.name] = execute(step.rel.plan, env, memo, scalars)
            continue
        if step.kind != "append":
            raise ValueError(step.kind)
        new = execute(step.rel.plan, env, memo, scalars)
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
        env[step.name] = DenseTable(keys=cache.keys, cols=cols,
                                    col_types=cache.col_types)

    outputs = {o: env[o] for o in pipeline.outputs}
    return outputs, env
