"""End-to-end serving driver of the PyTorch/CUDA port: batched requests
under a memory cap.

    python examples/serve_paged_torch.py [--shards N|auto] [--device cuda]
    PYTHONPATH=src python examples/serve_paged_torch.py --device cpu

Serves a small Llama with the paper's disk+mem relational engine (weights
memmapped on disk, bounded device working set, prefetch) while a
continuous-batching scheduler multiplexes requests over a paged KV cache —
the production shape of the paper's single-request DuckDB experiment.
``--shards N`` splits every eligible matmul site across N tensor-parallel
workers (each paging its weight slices under ``budget // N``) and reports
per-worker occupancy and pager hit rates in the end-of-run summary.
"""

import argparse
import json
import os
import tempfile
import time

import numpy as np

from repro_torch.core.llama_graph import LlamaSpec, init_llama_params
from repro_torch.obs import MetricsRegistry, TraceRecorder
from repro_torch.serving.engine import RelationalEngine
from repro_torch.serving.kvcache import PagedKVCache, PagedKVConfig
from repro_torch.serving.scheduler import ContinuousBatcher, Request


def _pct(h, p):
    v = h.percentile(p)
    return f"{v*1e3:.1f} ms" if v == v else "n/a"  # NaN-safe


def print_metrics_summary(reg: MetricsRegistry) -> None:
    """End-of-run serving summary straight from the metrics registry."""

    def get(kind, name, **labels):
        return getattr(reg, kind)(name, **labels)

    ttft = get("histogram", "serving_ttft_seconds")
    tick = get("histogram", "serving_tick_seconds")
    occ = get("gauge", "serving_batch_occupancy")
    hits = get("counter", "pager_hits_total").value
    pf_hits = get("counter", "pager_prefetch_hits_total").value
    misses = get("counter", "pager_misses_total").value
    total = hits + pf_hits + misses
    print("\nmetrics summary:")
    print(f"  ttft: p50={_pct(ttft, 50)} p95={_pct(ttft, 95)} "
          f"(n={ttft.count})")
    print(f"  decode tick: p50={_pct(tick, 50)} p95={_pct(tick, 95)} "
          f"mean={tick.mean*1e3:.1f} ms (n={tick.count})")
    print(f"  batch occupancy (last tick): {occ.value:.2f}")
    print(f"  pager hit rate: "
          f"{(hits + pf_hits) / total if total else 0.0:.2%} "
          f"({int(hits)} hot + {int(pf_hits)} prefetched / {int(total)})")
    print(f"  preemptions: "
          f"{int(get('counter', 'serving_preemptions_total').value)}  "
          f"completed: "
          f"{int(get('counter', 'serving_completed_total').value)}")


def print_shard_summary(eng: RelationalEngine, wall_s: float) -> None:
    """Per-worker occupancy and pager hit rates for a sharded engine."""
    pool = eng.shard_pool
    if pool is None:
        return
    st = pool.stats
    print(f"\nshard workers (n={pool.n}):")
    print(f"  sharded fan-outs: {st.sites}  busy sum={st.fanout_s:.2f}s  "
          f"critical path={st.critical_s:.2f}s  "
          f"projected multi-core saving={st.projected_saving_s:.2f}s")
    for w in pool.workers:
        h = w.metrics.histogram("shard_worker_busy_seconds")
        occ = h.sum / wall_s if wall_s > 0 else 0.0
        line = (f"  worker {w.index}: runs={h.count} "
                f"busy={h.sum:.2f}s occupancy={occ:.1%}")
        if w.pager is not None:
            s = w.pager.stats
            total = s.hits + s.prefetch_hits + s.misses
            rate = (s.hits + s.prefetch_hits) / total if total else 0.0
            line += (f" pager_hit_rate={rate:.2%} "
                     f"({s.hits + s.prefetch_hits}/{total}, "
                     f"evictions={s.evictions})")
        print(line)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--shards", default="1",
                    help="tensor-parallel worker count (int or 'auto')")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs (cuda, or cpu)")
    args = ap.parse_args()
    shards = args.shards if args.shards == "auto" else int(args.shards)
    spec = LlamaSpec(vocab=512, d_model=128, n_layers=3, n_heads=4, n_kv=2,
                     d_ff=256, rope_theta=10000.0)
    params = init_llama_params(spec, seed=0)
    model_bytes = sum(a.size * a.dtype.itemsize for a in params.values())
    metrics = MetricsRegistry()
    out = os.environ.get("OBS_ARTIFACT_DIR")
    # a tracer makes the shard workers record spans too, so the merged
    # coordinator+per-shard Chrome trace dumped below has real events
    tracer = TraceRecorder() if out else None

    with tempfile.TemporaryDirectory() as disk:
        print(f"model: {model_bytes/1e6:.1f} MB; cap: "
              f"{model_bytes/4/1e6:.1f} MB; cold store: {disk}")
        eng = RelationalEngine(spec, params, chunk_size=64,
                               residency="paged",
                               budget_bytes=model_bytes // 4,
                               disk_dir=disk, max_len=96,
                               metrics=metrics, tracer=tracer,
                               shards=(shards if shards != 1 else None),
                               device=args.device)
        if eng.shard_pool is not None:
            sp = eng.decode_pipe.shard_plan
            print(f"sharded: {eng.shards} workers, "
                  f"{len(sp.decisions) if sp else 0} decode sites, "
                  f"per-worker budget "
                  f"{model_bytes / 4 / eng.shards / 1e6:.1f} MB")
        t_work0 = time.perf_counter()

        # --- single-request latency under the cap -------------------------
        rng = np.random.default_rng(0)
        res = eng.generate(list(rng.integers(0, spec.vocab, 24)),
                           max_new_tokens=8)
        print(f"single request: ttft={res.ttft_s*1e3:.1f} ms "
              f"tpot={res.tpot_s*1e3:.1f} ms peak_ws="
              f"{res.peak_working_set/1e6:.1f} MB "
              f"pager={res.pager_stats}")

        # --- continuous batching over a paged KV cache --------------------
        # one seq-keyed relational plan advances the WHOLE batch per tick
        # (no per-sequence decode loop): the batched decoder gathers the
        # active sequences' cache-table slots, runs one `run_pipeline`,
        # and scatters the appended rows back
        kvcfg = PagedKVConfig(n_layers=spec.n_layers, n_kv=spec.n_kv,
                              head_dim=spec.head_dim, page_size=8,
                              n_pages=64, max_pages_per_seq=12)
        kv = PagedKVCache(kvcfg, max_seqs=8, device=args.device)
        dec = eng.batched_decoder(max_seqs=8)

        def prefill(req, seq_id):
            # req.context, not req.prompt: a preempted request re-prefills
            # over its delivered tokens too, resuming instead of replaying
            ctx = req.context
            kv.ensure_capacity(seq_id, len(ctx))
            return dec.prefill(ctx, seq_id)

        # decode_fn IS the batched decoder — the scheduler owns the
        # kv.seq_lens bookkeeping, so no wrapper is needed
        sched = ContinuousBatcher(kv, prefill, dec.decode, max_batch=3,
                                  release_fn=dec.free, metrics=metrics)
        t0 = time.perf_counter()
        for r in range(5):
            sched.submit(Request(rid=r,
                                 prompt=list(rng.integers(0, spec.vocab,
                                                          8 + 4 * r)),
                                 max_new_tokens=4))
        done = sched.run()
        dt = time.perf_counter() - t0
        print(f"\nserved {len(done)} requests in {dt:.1f}s "
              f"(ticks={sched.stats.ticks} decode_steps="
              f"{sched.stats.decode_steps} batched_plan_calls="
              f"{dec.decode_calls} preemptions="
              f"{sched.stats.preemptions})")
        for req in done:
            print(f"  req{req.rid}: prompt={len(req.prompt)}t "
                  f"gen={req.generated} ttft={req.first_token_s:.2f}s")

        print_metrics_summary(metrics)
        print_shard_summary(eng, time.perf_counter() - t_work0)
        # fold per-worker registries into the main one (shard-labelled)
        # BEFORE the artifact dump so the JSON carries the worker series
        eng.merge_shard_metrics()
        if out:
            os.makedirs(out, exist_ok=True)
            metrics.save_json(os.path.join(out, "serve_paged_metrics.json"))
            with open(os.path.join(out, "serve_paged_metrics.prom"),
                      "w") as f:
                f.write(metrics.render_prometheus())
            if eng.shard_pool is not None:
                with open(os.path.join(out, "serve_paged_shard_trace.json"),
                          "w") as f:
                    json.dump(eng.merged_shard_trace(), f)
            print(f"metrics dumped to {out}/")
        if eng.shard_pool is not None:
            eng.shard_pool.shutdown()


if __name__ == "__main__":
    main()
