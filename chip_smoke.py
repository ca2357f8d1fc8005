#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a) and the CUDA
toolkit's ``nvcc``.  It builds every hand-written kernel from the sources in
this checkout, holds each against its plain PyTorch version on the card,
runs the engine at Llama-3-8B width on the card against the same engine on
the CPU (depth 2), then serves a few requests at full width and depth
through ``ContinuousBatcher`` → ``BatchedDecoder`` → ``RelationalEngine``
and checks that every GEMM of that run went through the kernel.  Any
failure exits non-zero.  The last line is
``{"ok": true, "device": {...}}``; the line before it lists the kernels
with their launches, errors and times (the per-shape times are printed in
phase 3).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Llama-3-8B widths (src/repro/configs/llama3_8b.py)
VOCAB, D_MODEL, N_HEADS, N_KV, D_FF, THETA = 128256, 4096, 32, 8, 14336, 5e5
N_LAYERS = 32

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): memory bytes/s
# and non-tensor-core float32 FLOP/s.  The bound of a kernel is the larger
# of bytes / memory rate and flops / f32 rate.
PEAKS = (3.35e12, 67e12)

SWEEP = [(32, 32, 32), (96, 64, 160), (17, 23, 40), (128, 128, 256),
         (1, 64, 160), (4, 23, 40), (16, 33, 300)]
MAIN_M = (1, 4, 64)
MAIN_NK = {"o/Q": (4096, 4096), "K/V": (1024, 4096), "W1/W3": (14336, 4096),
           "W2": (4096, 14336), "lm_head": (128256, 4096)}
# GEMM launches of one decode step per weight shape (7 per layer + lm_head)
STEP_COUNTS = {"o/Q": 2 * N_LAYERS, "K/V": 2 * N_LAYERS,
               "W1/W3": 2 * N_LAYERS, "W2": N_LAYERS, "lm_head": 1}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def log(msg: str = "") -> None:
    print(msg, flush=True)


def time_ms(fn, flush: torch.Tensor, reps: int = 20, warmup: int = 3):
    """Median device time of ``fn`` over ``reps`` launches timed one by
    one with CUDA events, the L2 cache flushed before each (decode reads
    its weights cold)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    log("== phase 1: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    log(card)
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device 0: {name}, {torch.cuda.device_count()} visible")
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on"
    assert torch.get_float32_matmul_precision() == "highest"
    log(f"bounds use the H100 SXM peaks: {PEAKS[0] / 1e12} TB/s, "
        f"{PEAKS[1] / 1e12} TFLOP/s f32")
    return name


def phase_build():
    from repro_torch.kernels import build_chunked_matmul
    log("== phase 2: build")
    t0 = time.perf_counter()
    lib = build_chunked_matmul()
    log(f"K1 chunked_matmul built in {time.perf_counter() - t0:.3f} s: "
        f"{lib.relative_to(ROOT) if lib.is_relative_to(ROOT) else lib}")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def phase_kernels():
    from repro_torch.kernels import chunked_matmul, ref
    log("== phase 3: K1 chunked_matmul against its plain version")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for m, n, k in SWEEP:
            x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
            w = torch.randn(n, k, generator=gen, device=dev).to(dtype)
            got, want = chunked_matmul(x, w), ref.chunked_matmul(x, w)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=TOL[dtype], atol=TOL[dtype])
            if dtype == torch.float32:
                max_err = max(max_err, (got - want).abs().max().item())
    log(f"sweep {SWEEP} in f32 and bf16: ok")

    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    rows = []
    for label, (n, k) in MAIN_NK.items():
        w = torch.randn(n, k, generator=gen, device=dev).mul_(k ** -0.5)
        for m in MAIN_M:
            x = torch.randn(m, k, generator=gen, device=dev)
            got, want = chunked_matmul(x, w), ref.chunked_matmul(x, w)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
            err = (got - want).abs().max().item()
            max_err = max(max_err, err)
            nbytes = 4 * (m * k + n * k + m * n)
            flops = 2 * m * n * k
            bound = max(nbytes / PEAKS[0], flops / PEAKS[1]) * 1e3
            row = {
                "site": label, "M": m, "N": n, "K": k,
                "kernel_ms": time_ms(lambda: chunked_matmul(x, w), flush),
                "plain_ms": time_ms(lambda: ref.chunked_matmul(x, w), flush),
                "library_ms": time_ms(lambda: torch.matmul(x, w.T), flush),
                "bound_ms": bound,
                "bound_by": ("bytes" if nbytes / PEAKS[0] >= flops / PEAKS[1]
                             else "operations"),
                "max_abs_err": err,
            }
            rows.append(row)
            log(f"  {label:8s} M={m:3d} N={n:6d} K={k:5d}  "
                f"kernel {row['kernel_ms']:.4f} ms  plain "
                f"{row['plain_ms']:.4f} ms  library {row['library_ms']:.4f}"
                f" ms  bound {bound:.4f} ms ({row['bound_by']})  "
                f"max|err| {err:.2e}")
        del w
    del flush
    step = {key: sum(r[key] * STEP_COUNTS[r["site"]] for r in rows
                     if r["M"] == 1)
            for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
    log(f"one decode step's {sum(STEP_COUNTS.values())} GEMMs at M=1: "
        f"kernel {step['kernel_ms']:.3f} ms, plain {step['plain_ms']:.3f} "
        f"ms, library {step['library_ms']:.3f} ms, bound "
        f"{step['bound_ms']:.3f} ms")
    return rows, step, max_err


def phase_engine_parity():
    from repro_torch.core.llama_graph import LlamaSpec, init_llama_params
    from repro_torch.serving.engine import RelationalEngine
    log("== phase 4: engine at Llama-3-8B width, depth 2: GPU against CPU")
    spec = LlamaSpec(vocab=VOCAB, d_model=D_MODEL, n_layers=2,
                     n_heads=N_HEADS, n_kv=N_KV, d_ff=D_FF, rope_theta=THETA)
    t0 = time.perf_counter()
    params = init_llama_params(spec, seed=0)
    log(f"numpy weights (seed 0): {time.perf_counter() - t0:.1f} s")
    engines = {d: RelationalEngine(spec, params, chunk_size=64, max_len=64,
                                   device=d) for d in ("cuda", "cpu")}
    prompt = [int(t) for t in
              np.random.default_rng(1).integers(0, VOCAB, 32)]
    sess = {d: e.start_session(prompt) for d, e in engines.items()}
    max_diff, gpu_toks, cpu_toks = 0.0, [], []
    for step in range(5):
        if step:
            for d in engines:
                # teacher-force the GPU's token so both see one sequence
                sess[d]["tok"] = gpu_toks[-1]
                engines[d].session_step(sess[d])
        lg_gpu, lg_cpu = sess["cuda"]["logits"], sess["cpu"]["logits"]
        np.testing.assert_allclose(lg_gpu, lg_cpu, rtol=1e-3, atol=1e-3)
        max_diff = max(max_diff, float(np.abs(lg_gpu - lg_cpu).max()))
        top2 = np.sort(lg_cpu)[-2:]
        gpu_toks.append(int(np.argmax(lg_gpu)))
        cpu_toks.append(int(np.argmax(lg_cpu)))
        if top2[1] - top2[0] > 1e-3:
            assert gpu_toks[-1] == cpu_toks[-1], (gpu_toks, cpu_toks)
    log(f"prefill T=32 + 4 decode steps: max|Δlogit| GPU vs CPU "
        f"{max_diff:.3e}")
    log(f"tokens GPU {gpu_toks}")
    log(f"tokens CPU {cpu_toks}")
    del engines, sess, params
    torch.cuda.empty_cache()
    return max_diff


def phase_serving(n_layers: int):
    from repro_torch.core.llama_graph import LlamaSpec, init_llama_tensors
    from repro_torch.kernels import chunked_matmul
    from repro_torch.serving.engine import RelationalEngine
    from repro_torch.serving.kvcache import PagedKVCache, PagedKVConfig
    from repro_torch.serving.scheduler import ContinuousBatcher, Request
    log(f"== phase 5: serving at Llama-3-8B width, {n_layers} layers, "
        f"on the card")
    if n_layers != N_LAYERS:
        log(f"depth cut: {n_layers} of {N_LAYERS} layers")
    spec = LlamaSpec(vocab=VOCAB, d_model=D_MODEL, n_layers=n_layers,
                     n_heads=N_HEADS, n_kv=N_KV, d_ff=D_FF, rope_theta=THETA)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_llama_tensors(spec, seed=0, device="cuda")
    eng = RelationalEngine(spec, params, chunk_size=64, max_len=512,
                           row2col="off", cache_layout="off", device="cuda")
    del params
    torch.cuda.synchronize()
    n_params = sum(t.cols[c].numel() for t in eng.env_base.values()
                   for c in t.cols)
    log(f"weights on the card: {n_params / 1e9:.3f} B parameters, "
        f"{4 * n_params / 1e9:.2f} GB f32, drawn and converted in "
        f"{time.perf_counter() - t0:.1f} s")

    kv = PagedKVCache(PagedKVConfig(n_layers=n_layers, n_kv=N_KV,
                                    head_dim=D_MODEL // N_HEADS,
                                    page_size=16, n_pages=64,
                                    max_pages_per_seq=32),
                      max_seqs=4, device="cuda")
    dec = eng.batched_decoder(max_seqs=4, prefix_block=0)

    def prefill(req, seq_id):
        ctx = req.context
        kv.ensure_capacity(seq_id, len(ctx))
        return dec.prefill(ctx, seq_id)

    sched = ContinuousBatcher(kv, prefill, dec.decode, max_batch=3,
                              release_fn=dec.free)
    rng = np.random.default_rng(2)
    lengths = (32, 64, 32, 64)
    for rid, n in enumerate(lengths):
        sched.submit(Request(rid=rid, prompt=[int(t) for t in
                                              rng.integers(0, VOCAB, n)],
                             max_new_tokens=8))
    # compile the plans the run needs first, so TTFT/TPOT are steady state
    t0 = time.perf_counter()
    for n in sorted(set(lengths)):
        eng._prefill_pipe(n)
    for bucket in (1, 2, 4):
        eng._batched_decode_pipe(bucket)
    log(f"plans compiled (prefill T={sorted(set(lengths))}, batch buckets "
        f"1, 2, 4) in {time.perf_counter() - t0:.2f} s")
    chunked_matmul.launches = chunked_matmul.calls = 0
    t0 = time.perf_counter()
    done = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = chunked_matmul.launches
    pipeline_calls = sched.stats.prefills + dec.decode_calls
    per_call = 7 * n_layers + 1
    assert len(done) == len(lengths), done
    for req in done:
        assert len(req.generated) == 8, (req.rid, req.generated)
        assert all(0 <= t < VOCAB for t in req.generated)
    assert launches == per_call * pipeline_calls, (launches, pipeline_calls)
    assert chunked_matmul.calls == launches
    log(f"served {len(done)} requests in {wall:.2f} s: ticks "
        f"{sched.stats.ticks}, prefills {sched.stats.prefills}, decode "
        f"ticks {dec.decode_calls}, preemptions {sched.stats.preemptions}")
    log(f"chunked_matmul launches {launches} = {per_call} x "
        f"{pipeline_calls} run_pipeline calls")
    for req in sorted(done, key=lambda r: r.rid):
        tpot = (req.done_s - req.first_token_s) / (len(req.generated) - 1)
        log(f"  req{req.rid}: prompt {len(req.prompt)} tokens, ttft "
            f"{req.first_token_s * 1e3:.1f} ms, tpot {tpot * 1e3:.1f} ms, "
            f"tokens {req.generated}")
    log(f"max memory allocated {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB")
    profile_tick(dec)
    del eng, dec, kv
    torch.cuda.empty_cache()
    return launches


def profile_tick(dec) -> None:
    """Where one batched decode tick (3 sequences) spends device time:
    kernels by name from ``torch.profiler``, and the device's idle share of
    the tick's host wall time."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(3)
    last = [dec.prefill([int(t) for t in rng.integers(0, VOCAB, 32)], s)
            for s in range(3)]
    for _ in range(2):  # warm: view cache and allocator
        last = dec.decode([0, 1, 2], last)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        dec.decode([0, 1, 2], last)
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, busy = {}, 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy += us
            by_name[e.name] = by_name.get(e.name, 0.0) + us
    if not by_name:
        log("tick profile: the profiler recorded no device time "
            "(device busy share not measured)")
        return
    log(f"one decode tick (B=3, bucket 4): wall {wall_us / 1e3:.2f} ms, "
        f"device busy {busy / 1e3:.2f} ms, idle share "
        f"{1 - busy / wall_us:.3f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  {us / 1e3:9.3f} ms  {us / busy:6.1%}  {name[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout)
    t_all = time.perf_counter()

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        log(f"{label} wall {time.perf_counter() - t0:.1f} s")
        return result

    name = timed("phase 1", phase_device)
    timed("phase 2", phase_build)
    rows, step, max_err = timed("phase 3", phase_kernels)
    timed("phase 4", phase_engine_parity)
    launches = timed("phase 5", phase_serving, N_LAYERS)
    log("kernels: K1 chunked_matmul: ok")
    log(f"total wall {time.perf_counter() - t_all:.1f} s")
    log(json.dumps({"kernels": [{
        "name": "chunked_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/chunked_matmul.cu",
        "replaces": "src/repro/kernels/chunked_matmul.py:42",
        "launches": launches, "max_abs_err": max_err,
        "ms": step["kernel_ms"], "plain_ms": step["plain_ms"],
        "bound_ms": step["bound_ms"],
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in rows
                                    if r["M"] == 1) else "operations"),
        "library_ms": step["library_ms"],
        "times_are": f"one decode step's {sum(STEP_COUNTS.values())} GEMMs "
                     f"at M=1, summed from per-shape medians"}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
