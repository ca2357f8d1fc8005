"""Boot the PyTorch/CUDA port's OpenAI-compatible HTTP front end.

    python examples/serve_http_torch.py [--device cuda] [--port 8008]
        [--max-batch 3] [--paged] [--n-pages 48] [--max-queue 32]
        [--llama3-8b-width]

On the CPU (no card needed; the kernels' plain versions run):

    PYTHONPATH=src python examples/serve_http_torch.py --device cpu

The tiny model is the default (the same spec and numpy weights as
``examples/serve_http.py``); ``--llama3-8b-width`` serves random weights
at Llama-3-8B's widths and depth on the card under the reference's
planned defaults, every matmul on K1 ``chunked_matmul`` and every
attention on K2 ``paged_attention`` / K3 ``flash_attention``.

Then drive it with curl:

    curl -s localhost:8008/v1/models
    curl -s localhost:8008/v1/completions -d '{
        "model": "transql-tiny", "prompt": [5, 9, 2, 7],
        "max_tokens": 6, "stream": true}'
    curl -s localhost:8008/metrics | grep serving_ttft

or with the load generator (``examples/load_client.py``, which speaks
HTTP only), which also verifies SSE chunk ordering and token exactness
under concurrency.

With ``OBS_ARTIFACT_DIR`` set, a ``TraceRecorder`` is attached and
shutdown (Ctrl-C or ``POST /admin/shutdown``) dumps the metrics registry
(JSON + Prometheus text), the flight recorder's Chrome trace and the
flight dump there.  The tracer stamps the host's side of each step and
reads the card's time from CUDA events; it does not wait for the card.

Live debugging: ``GET /debug/flight`` for the recent-tick ring,
``GET /debug/trace/{trace_id}`` for one request's end-to-end Chrome trace
(the id rides on every response and SSE chunk; its spans need the
tracer), ``GET /debug/drift`` for the watchdog state (``--drift-every N``
enables mid-flight re-planning on cost-model drift).
"""

import argparse
import asyncio
import contextlib
import json
import os
import tempfile

from repro_torch.core.llama_graph import (LlamaSpec, init_llama_params,
                                          init_llama_tensors)
from repro_torch.obs import MetricsRegistry, TraceRecorder
from repro_torch.serving.engine import RelationalEngine
from repro_torch.serving.kvcache import PagedKVCache, PagedKVConfig
from repro_torch.serving.server import AsyncLLMServer, ServerConfig

# Llama-3-8B's widths and depth
LLAMA3_8B = dict(vocab=128256, d_model=4096, n_layers=32, n_heads=32,
                 n_kv=8, d_ff=14336, rope_theta=5e5)


def build_server(args, metrics, tracer, disk_dir=None) -> AsyncLLMServer:
    if args.llama3_8b_width:
        spec = LlamaSpec(**LLAMA3_8B)
        params = init_llama_tensors(spec, seed=0, device=args.device)
        chunk, max_len, page, model_id = 64, 512, 16, "transql-llama3-8b"
    else:
        spec = LlamaSpec(vocab=512, d_model=128, n_layers=3, n_heads=4,
                         n_kv=2, d_ff=256, rope_theta=10000.0)
        params = init_llama_params(spec, seed=0)
        chunk, max_len, page, model_id = 64, 96, 8, "transql-tiny"
    knobs = dict(chunk_size=chunk, max_len=max_len, metrics=metrics,
                 tracer=tracer, device=args.device)
    if args.paged:
        model_bytes = sum(a.nbytes for a in params.values())
        knobs.update(residency="paged", budget_bytes=model_bytes // 4,
                     disk_dir=disk_dir)
    eng = RelationalEngine(spec, params, **knobs)
    del params
    # a page pool sized below max_batch's worst case keeps the preemption
    # path honest under load (the scheduler resumes, never replays)
    kvcfg = PagedKVConfig(n_layers=spec.n_layers, n_kv=spec.n_kv,
                          head_dim=spec.head_dim, page_size=page,
                          n_pages=args.n_pages,
                          max_pages_per_seq=max_len // page)
    kv = PagedKVCache(kvcfg, max_seqs=max(8, args.max_batch),
                      device=args.device)
    cfg = ServerConfig(host=args.host, port=args.port, model_id=model_id,
                       max_batch=args.max_batch,
                       max_queue_depth=args.max_queue,
                       max_tokens_cap=args.max_tokens_cap,
                       ttft_slo_s=args.ttft_slo_ms / 1e3
                       if args.ttft_slo_ms else None,
                       tpot_slo_s=args.tpot_slo_ms / 1e3
                       if args.tpot_slo_ms else None,
                       flight_capacity=args.flight_capacity,
                       drift_every=args.drift_every,
                       drift_threshold=args.drift_threshold)
    return AsyncLLMServer(eng, kv, cfg, metrics=metrics, tracer=tracer)


def dump_artifacts(server, metrics, out: str) -> None:
    os.makedirs(out, exist_ok=True)
    metrics.save_json(os.path.join(out, "serve_http_metrics.json"))
    with open(os.path.join(out, "serve_http_metrics.prom"), "w") as f:
        f.write(metrics.render_prometheus())
    # the scheduler drains the tracer into the flight recorder per tick,
    # so the flight ring holds the retained spans
    server.flight.save(os.path.join(out, "serve_http_trace.json"))
    with open(os.path.join(out, "serve_http_flight.json"), "w") as f:
        json.dump(server.flight.to_dict(), f, default=str)
    print(f"artifacts dumped to {out}/")


async def amain(args) -> None:
    metrics = MetricsRegistry()
    out = os.environ.get("OBS_ARTIFACT_DIR")
    tracer = TraceRecorder() if out else None
    with contextlib.ExitStack() as stack:
        disk = (stack.enter_context(tempfile.TemporaryDirectory())
                if args.paged else None)
        server = build_server(args, metrics, tracer, disk_dir=disk)
        await server.start()
        print(f"serving {server.cfg.model_id} on "
              f"http://{server.cfg.host}:{server.port} "
              f"(device={args.device}, "
              f"max_batch={server.batcher.max_batch}, "
              f"queue_depth={server.cfg.max_queue_depth}, "
              f"residency={'paged' if args.paged else 'in_memory'}, "
              f"tracing={'on' if tracer is not None else 'off'})",
              flush=True)
        try:
            await server._shutdown_ev.wait()
        except (KeyboardInterrupt, asyncio.CancelledError):
            pass
        finally:
            await server._aclose()
            if out:
                dump_artifacts(server, metrics, out)


def main():
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs (cuda, or cpu)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8008)
    ap.add_argument("--max-batch", type=int, default=3)
    ap.add_argument("--max-queue", type=int, default=32)
    ap.add_argument("--max-tokens-cap", type=int, default=64)
    ap.add_argument("--n-pages", type=int, default=48,
                    help="KV page pool size (small pools force preemption)")
    ap.add_argument("--paged", action="store_true",
                    help="disk+mem weight residency instead of in-memory")
    ap.add_argument("--llama3-8b-width", action="store_true",
                    help="random weights at Llama-3-8B's widths")
    ap.add_argument("--ttft-slo-ms", type=float, default=None)
    ap.add_argument("--tpot-slo-ms", type=float, default=None)
    ap.add_argument("--flight-capacity", type=int, default=256,
                    help="scheduler ticks retained by the flight recorder")
    ap.add_argument("--drift-every", type=int, default=0,
                    help="drift-watchdog cadence in ticks (0 = off)")
    ap.add_argument("--drift-threshold", type=float, default=0.5,
                    help="RMS relative drift that triggers a re-plan")
    args = ap.parse_args()
    try:
        asyncio.run(amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
