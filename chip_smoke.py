#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a) and the CUDA
toolkit's ``nvcc``.  It builds every hand-written kernel from the sources in
this checkout, holds each against its plain PyTorch version on the card,
runs the engine at Llama-3-8B width on the card against the same engine on
the CPU (depth 2, a single sequence and a batched decoder), then serves a
few requests at full width and depth through ``ContinuousBatcher`` →
``BatchedDecoder`` → ``RelationalEngine`` and checks that every GEMM of that
run went through K1 ``chunked_matmul``, every decode attention through K2
``paged_attention`` and every prefill attention through K3
``flash_attention``.  Any failure exits non-zero.  The last line is
``{"ok": true, "device": {...}}``; the line before it lists the kernels
with their launches, errors and times (the per-shape times are printed in
phase 3).
"""

from __future__ import annotations

import importlib
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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
# of bytes / memory rate and flops / the rate of the units it computes on:
# the f32 rate for K1 and K2; for K3, which multiplies on the tensor cores,
# dense TF32 over 3 in f32 (3xTF32: three products an element) and dense
# bf16 in bf16 (its f32-FMA bound is reported beside).
PEAKS = (3.35e12, 67e12)
TENSOR_PEAKS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}

# K1: the sweep of tests/test_kernels.py, then ragged N, a K that is no
# multiple of the 16-byte vector (the scalar path) and split-K shapes
SWEEP = [(32, 32, 32), (96, 64, 160), (17, 23, 40), (128, 128, 256),
         (1, 64, 160), (4, 23, 40), (16, 33, 300), (1, 1023, 301),
         (2, 100, 301), (64, 1023, 301), (16, 1024, 4096), (17, 1024, 4096)]
# decode rows (batch buckets 1, 2, 4) and a 64-token prefill
MAIN_M = (1, 2, 4, 64)
PREFILL_M = 64
MAIN_NK = {"o/Q": (4096, 4096), "K/V": (1024, 4096), "W1/W3": (14336, 4096),
           "W2": (4096, 14336), "lm_head": (128256, 4096)}
# GEMM launches of one decode step, or one prefill, per weight shape (7 per
# layer + lm_head)
STEP_COUNTS = {"o/Q": 2 * N_LAYERS, "K/V": 2 * N_LAYERS,
               "W1/W3": 2 * N_LAYERS, "W2": N_LAYERS, "lm_head": 1}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

# attention at Llama-3-8B widths over a 512-row cache (phase 5's max_len)
HEAD_DIM, MAX_LEN = D_MODEL // N_HEADS, 512
# K2: (B, lengths) per decode shape; K3: prompt lengths T
PAGED_MAIN = [(1, [33]), (1, [72]), (1, [512]), (4, [33] * 4), (4, [72] * 4),
              (4, [512] * 4), (4, [33, 72, 100, 512])]
FLASH_MAIN = [32, 64, 512]
# the shapes the kernels JSON line reports: one decode tick of phase 5's
# mixed batch, one prefill of a 64-token prompt (32 launches each)
PAGED_STEP, FLASH_STEP = (4, [33, 72, 100, 512]), 64
# the sweeps of tests/test_kernels.py
PAGED_SWEEP = [[5, 17, 32], [1, 1, 1], [32, 8, 24]]
FLASH_SWEEP = [(32, 32, 16, True), (64, 64, 32, True), (32, 64, 16, False),
               (128, 128, 64, True)]
KERNELS = ("chunked_matmul", "paged_attention", "flash_attention")


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
        f"{PEAKS[1] / 1e12} TFLOP/s f32; K3 on the tensor cores at "
        f"{TENSOR_PEAKS[torch.float32] / 1e12:.0f} TFLOP/s (TF32 / 3)")
    return name


def phase_build():
    """One nvcc per kernel source, all started together."""
    from repro_torch.kernels import _build
    log("== phase 2: build")

    def build(name):
        t0 = time.perf_counter()
        return _build.build(name), time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = list(pool.map(build, KERNELS))
    for i, (name, (lib, secs)) in enumerate(zip(KERNELS, built)):
        log(f"K{i + 1} {name} built in {secs:.3f} s: "
            f"{lib.relative_to(ROOT) if lib.is_relative_to(ROOT) else lib}")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")


def phase_kernels():
    from repro_torch.kernels import chunked_matmul, ref
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.chunked_matmul import _aligned, _plan
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
        # rows that start one element off the 16-byte grid: the scalar path
        wide = torch.randn(5, 4097, generator=gen, device=dev).to(dtype)
        w = torch.randn(300, 4096, generator=gen, device=dev).to(dtype)
        x = wide[:, 1:]
        assert not _aligned(x, w)
        got = chunked_matmul(x, w)
        torch.testing.assert_close(got.float(),
                                   ref.chunked_matmul(x, w).float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])
    log(f"sweep {SWEEP} and misaligned rows, f32 and bf16: ok")

    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    rows = []
    for label, (n, k) in MAIN_NK.items():
        w = torch.randn(n, k, generator=gen, device=dev).mul_(k ** -0.5)
        for m in MAIN_M:
            x = torch.randn(m, k, generator=gen, device=dev)
            got, want = chunked_matmul(x, w), ref.chunked_matmul(x, w)
            again = chunked_matmul(x, w)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
            assert torch.equal(got, again), f"{label} M={m}: not repeatable"
            err = (got - want).abs().max().item()
            max_err = max(max_err, err)
            plan = _plan(m, n, k, x.dtype, _aligned(x, w), sm_count(dev))
            bound, by = _bound(4 * (m * k + n * k + m * n), 2 * m * n * k)
            row = {
                "site": label, "M": m, "N": n, "K": k,
                "kernel_ms": time_ms(lambda: chunked_matmul(x, w), flush),
                "plain_ms": time_ms(lambda: ref.chunked_matmul(x, w), flush),
                "library_ms": time_ms(lambda: torch.matmul(x, w.T), flush),
                "bound_ms": bound, "bound_by": by, "max_abs_err": err,
                "plan": f"{plan.regime} tile {plan.tile} splits "
                        f"{plan.splits} ({plan.blocks} blocks)",
            }
            rows.append(row)
            log(f"  {label:8s} M={m:3d} N={n:6d} K={k:5d}  "
                f"kernel {row['kernel_ms']:.4f} ms  plain "
                f"{row['plain_ms']:.4f} ms  library {row['library_ms']:.4f}"
                f" ms  bound {bound:.4f} ms ({by})  max|err| {err:.2e}  "
                f"{row['plan']}")
        del w
    del flush
    steps = {}
    for m in MAIN_M:
        what = "prefill" if m == PREFILL_M else "decode step"
        step = {key: sum(r[key] * STEP_COUNTS[r["site"]] for r in rows
                         if r["M"] == m)
                for key in ("kernel_ms", "plain_ms", "library_ms",
                            "bound_ms")}
        step["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes"
                                           for r in rows if r["M"] == m)
                            else "operations")
        steps[m] = step
        log(f"one {what}'s {sum(STEP_COUNTS.values())} GEMMs at M={m}: "
            f"kernel {step['kernel_ms']:.3f} ms, plain "
            f"{step['plain_ms']:.3f} ms, library {step['library_ms']:.3f} ms,"
            f" bound {step['bound_ms']:.3f} ms ({step['bound_by']}); kernel "
            f"/ library {step['kernel_ms'] / step['library_ms']:.3f}, bound "
            f"/ kernel {step['bound_ms'] / step['kernel_ms']:.3f}")
    worst = {m: max(r["kernel_ms"] / r["library_ms"] for r in rows
                    if r["M"] == m) for m in MAIN_M}
    log(f"worst single shape, kernel / library: "
        f"{', '.join(f'M={m} {v:.3f}' for m, v in worst.items())}")
    return steps, max_err


def _bound(nbytes: float, flops: float, rate: float = PEAKS[1]):
    """(bound in ms, what bounds it) on the H100 SXM peaks, the flops at
    ``rate`` (default the f32 rate of the CUDA cores)."""
    t_bytes, t_ops = nbytes / PEAKS[0], flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _sweep_paged_case(gen, dev, dtype, lens, unmapped=()):
    """tests/test_kernels.py's K2 sweep: B = len(lens), H 8, Hkv 2, d 32,
    pages of 8 in a pool of 16, 4 pages per sequence, the pages below each
    length mapped in shuffled order except the (seq, page) pairs in
    ``unmapped``."""
    B, H, Hkv, d, page, P, MP = len(lens), 8, 2, 32, 8, 16, 4
    q = torch.randn(B, H, d, generator=gen, device=dev).to(dtype)
    kp = torch.randn(P, page, Hkv, d, generator=gen, device=dev).to(dtype)
    vp = torch.randn(P, page, Hkv, d, generator=gen, device=dev).to(dtype)
    pt = torch.full((B, MP), -1, dtype=torch.int32)
    used = iter(np.random.default_rng(sum(lens)).permutation(P).tolist())
    for b, n in enumerate(lens):
        for i in range(-(-n // page)):
            pt[b, i] = -1 if (b, i) in unmapped else next(used)
    return q, kp, vp, pt.to(dev), torch.tensor(lens, dtype=torch.int32,
                                               device=dev)


def phase_attention_kernels(flush):
    """K2 and K3 against their plain versions at the test sweeps and the
    main path's shapes, with kernel, plain, library and bound times."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    from repro_torch.kernels import flash_attention, paged_attention, ref
    from repro_torch.kernels._build import sm_count
    K2 = importlib.import_module("repro_torch.kernels.paged_attention")
    K3 = importlib.import_module("repro_torch.kernels.flash_attention")
    log("== phase 3: K2 paged_attention and K3 flash_attention against their "
        "plain versions")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    err = {"paged_attention": 0.0, "flash_attention": 0.0}

    def check(name, got, want, dtype):
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])
        e = (got.float() - want.float()).abs().max().item()
        if dtype == torch.float32:
            err[name] = max(err[name], e)
        return e

    for dtype in (torch.float32, torch.bfloat16):
        for lens in PAGED_SWEEP:
            args = _sweep_paged_case(gen, dev, dtype, lens)
            check("paged_attention", paged_attention(*args),
                  ref.paged_attention(*args), dtype)
        for T, S, d, causal in FLASH_SWEEP:
            q, k, v = (torch.randn(2, 2, n, d, generator=gen,
                                   device=dev).to(dtype) for n in (T, S, S))
            check("flash_attention", flash_attention(q, k, v, causal),
                  ref.flash_attention(q, k, v, causal), dtype)
    log(f"K2 sweep lengths {PAGED_SWEEP}, K3 sweep (T, S, d, causal) "
        f"{FLASH_SWEEP}, f32 and bf16: ok")
    # an unmapped page below the length is skipped: sequence 0 (length 20)
    # without its page 1 is page 0's 8 slots and page 2's first 4
    q, kp, vp, pt, ln = _sweep_paged_case(gen, dev, torch.float32,
                                          [20, 17, 32], unmapped={(0, 1)})
    got = paged_attention(q, kp, vp, pt, ln)
    e = check("paged_attention", got[:1], ref.paged_attention(
        q[:1], kp, vp, pt[:1, [0, 2]], torch.tensor([12], device=dev)),
        torch.float32)
    check("paged_attention", got[1:], ref.paged_attention(
        q[1:], kp, vp, pt[1:], ln[1:]), torch.float32)
    log(f"K2 skips an unmapped page below the length: ok (max|err| "
        f"{e:.2e} against the plain version over the mapped pages)")

    H, Hkv, d, S = N_HEADS, N_KV, HEAD_DIM, MAX_LEN
    sms = sm_count(dev)
    rows = []

    def row(name, shape, plan, kernel, plain, library, nbytes, flops,
            rate=PEAKS[1]):
        got, want, lib = kernel(), plain(), library()
        e = check(name, got, want, torch.float32)
        bound, by = _bound(nbytes, flops, rate)
        r = {"kernel": name, "shape": shape, "plan": plan,
             "kernel_ms": time_ms(kernel, flush),
             "plain_ms": time_ms(plain, flush),
             "library_ms": time_ms(library, flush),
             "bound_ms": bound, "bound_by": by, "max_abs_err": e,
             "library_err": (lib.float() - want.float()).abs().max().item()}
        extra = ""
        if rate != PEAKS[1]:
            r["bound_f32_fma_ms"] = _bound(nbytes, flops)[0]
            extra = f" (f32 FMA {r['bound_f32_fma_ms'] * 1e3:.3f} us)"
        rows.append(r)
        log(f"  {name} {shape:24s} kernel {r['kernel_ms']:.4f} ms  plain "
            f"{r['plain_ms']:.4f} ms  library {r['library_ms']:.4f} ms  "
            f"bound {bound * 1e3:.3f} us ({by}){extra}  max|err| {e:.2e}  "
            f"library max|err| {r['library_err']:.2e}  plan: {plan}")
        return r

    log(f"main-path shapes, f32: H {H}, Hkv {Hkv}, d {d}, cache {S} rows")
    step = {}
    for B, lens in PAGED_MAIN:
        # the executor's view of a [B, S, Hkv, d] cache: pages of 64 rows,
        # identity page table, lengths = positions + 1
        cache_k = torch.randn(B, S, Hkv, d, generator=gen, device=dev)
        cache_v = torch.randn(B, S, Hkv, d, generator=gen, device=dev)
        q = torch.randn(B, H, d, generator=gen, device=dev)
        page = math.gcd(S, 64)
        kp = cache_k.view(B * S // page, page, Hkv, d)
        vp = cache_v.view(B * S // page, page, Hkv, d)
        pt = torch.arange(B * S // page, dtype=torch.int32,
                          device=dev).view(B, S // page)
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        mask = (torch.arange(S, device=dev)[None, :] < ln[:, None])[
            :, None, None, :]
        kl, vl = cache_k.permute(0, 2, 1, 3), cache_v.permute(0, 2, 1, 3)
        live = sum(lens)
        plan = K2._plan(B, Hkv, S // page, page, d, torch.float32, sms)
        r = row("paged_attention", f"B={B} len={lens}",
                f"{plan.n_split} splits a (sequence, KV head) in one cluster, "
                f"{plan.blocks} blocks",
                lambda: paged_attention(q, kp, vp, pt, ln),
                lambda: ref.paged_attention(q, kp, vp, pt, ln),
                lambda: sdpa(q[:, :, None], kl, vl, attn_mask=mask,
                             enable_gqa=True)[:, :, 0],
                4 * (2 * live * Hkv * d + 2 * B * H * d), 4 * H * d * live)
        if (B, lens) == PAGED_STEP:
            step["paged_attention"] = r
        del cache_k, cache_v, kp, vp, kl, vl
    for T in FLASH_MAIN:
        # the executor's views: q [1, H, T, d] of a [T, H, d] table, k/v
        # [1, Hkv, S, d] of the [S, Hkv, d] cache tables
        q = torch.randn(T, H, d, generator=gen,
                        device=dev).permute(1, 0, 2)[None]
        k = torch.randn(S, Hkv, d, generator=gen,
                        device=dev).permute(1, 0, 2)[None]
        v = torch.randn(S, Hkv, d, generator=gen,
                        device=dev).permute(1, 0, 2)[None]
        pairs = sum(min(t + 1, S) for t in range(T))
        plan = K3._plan(1, T, S, H, Hkv, d, torch.float32, sms)
        r = row("flash_attention", f"T={T} S={S}",
                f"{plan.warps} warps on {plan.heads} heads x {plan.rows} "
                f"rows, {plan.bk}-row K/V tiles, "
                f"{'balanced, ' if plan.balance else ''}{plan.blocks} blocks",
                lambda: flash_attention(q, k, v, True),
                lambda: ref.flash_attention(q, k, v, True),
                lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True),
                4 * (2 * T * H * d + 2 * min(T, S) * Hkv * d),
                4 * H * d * pairs, TENSOR_PEAKS[torch.float32])
        if T == FLASH_STEP:
            step["flash_attention"] = r
    for name, r in step.items():
        log(f"one {'decode tick' if name == 'paged_attention' else 'prefill'}"
            f"'s {N_LAYERS} {name} launches at {r['shape']}: kernel "
            f"{N_LAYERS * r['kernel_ms']:.3f} ms, plain "
            f"{N_LAYERS * r['plain_ms']:.3f} ms, library "
            f"{N_LAYERS * r['library_ms']:.3f} ms, bound "
            f"{N_LAYERS * r['bound_ms']:.3f} ms")
    return rows, step, err


def _assert_logits(lg_gpu, lg_cpu):
    """The GPU-vs-CPU limits: logits within 1e-3, greedy tokens equal
    where the CPU's top-2 margin exceeds 1e-3."""
    np.testing.assert_allclose(lg_gpu, lg_cpu, rtol=1e-3, atol=1e-3)
    for g, c in zip(np.atleast_2d(lg_gpu), np.atleast_2d(lg_cpu)):
        top2 = np.sort(c)[-2:]
        if top2[1] - top2[0] > 1e-3:
            assert int(np.argmax(g)) == int(np.argmax(c)), (g, c)
    return float(np.abs(lg_gpu - lg_cpu).max())


def phase_engine_parity():
    import repro_torch.serving.engine as engine_mod
    from repro_torch.core.llama_graph import LlamaSpec, init_llama_params
    from repro_torch.kernels import flash_attention, paged_attention
    from repro_torch.serving.engine import RelationalEngine
    log("== phase 4: engine at Llama-3-8B width, depth 2: GPU against CPU")
    spec = LlamaSpec(vocab=VOCAB, d_model=D_MODEL, n_layers=2,
                     n_heads=N_HEADS, n_kv=N_KV, d_ff=D_FF, rope_theta=THETA)
    t0 = time.perf_counter()
    params = init_llama_params(spec, seed=0)
    log(f"numpy weights (seed 0): {time.perf_counter() - t0:.1f} s")
    engines = {d: RelationalEngine(spec, params, chunk_size=64, max_len=64,
                                   device=d) for d in ("cuda", "cpu")}
    paged_attention.launches = flash_attention.launches = 0
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
        max_diff = max(max_diff, _assert_logits(lg_gpu, lg_cpu))
        gpu_toks.append(int(np.argmax(lg_gpu)))
        cpu_toks.append(int(np.argmax(lg_cpu)))
    log(f"prefill T=32 + 4 decode steps: max|Δlogit| GPU vs CPU "
        f"{max_diff:.3e}")
    log(f"tokens GPU {gpu_toks}")
    log(f"tokens CPU {cpu_toks}")

    # a batched decoder: three prompts, four ticks; each pipeline call's
    # logits are taken from run_pipeline's outputs
    logits = {}
    run_pipeline = engine_mod.run_pipeline

    def recording(pipe, env, *args, **kwargs):
        outs, env = run_pipeline(pipe, env, *args, **kwargs)
        v = outs["logits"].cols["v"]
        logits[v.device.type] = v.reshape(v.shape[0], -1)[
            :, :VOCAB].cpu().numpy()
        return outs, env

    rng = np.random.default_rng(4)
    prompts = [[int(t) for t in rng.integers(0, VOCAB, n)]
               for n in (17, 32, 40)]
    decs = {d: e.batched_decoder(4) for d, e in engines.items()}
    bdiff = 0.0
    engine_mod.run_pipeline = recording
    try:
        last = []
        for s, p in enumerate(prompts):
            toks = {d: dec.prefill(p, s) for d, dec in decs.items()}
            bdiff = max(bdiff, _assert_logits(logits["cuda"][-1],
                                              logits["cpu"][-1]))
            last.append(toks["cuda"])
        ticks = []
        for _ in range(4):
            toks = {d: dec.decode([0, 1, 2], last) for d, dec in decs.items()}
            bdiff = max(bdiff, _assert_logits(logits["cuda"][:3],
                                              logits["cpu"][:3]))
            ticks.append((toks["cuda"], toks["cpu"]))
            last = toks["cuda"]
    finally:
        engine_mod.run_pipeline = run_pipeline
    log(f"batched decoder, prompts {[len(p) for p in prompts]}, 4 ticks at "
        f"bucket 4: max|Δlogit| GPU vs CPU {bdiff:.3e}")
    log(f"tokens per tick (GPU, CPU) {ticks}")
    prefills, decodes = 1 + len(prompts), 4 + decs["cuda"].decode_calls
    assert paged_attention.launches == spec.n_layers * decodes, (
        paged_attention.launches, decodes)
    assert flash_attention.launches == spec.n_layers * prefills, (
        flash_attention.launches, prefills)
    log(f"GPU side: paged_attention launches {paged_attention.launches} = "
        f"{spec.n_layers} x {decodes} decode run_pipeline calls, "
        f"flash_attention launches {flash_attention.launches} = "
        f"{spec.n_layers} x {prefills} prefill calls")
    del engines, sess, params, decs
    torch.cuda.empty_cache()
    return max(max_diff, bdiff)


def phase_serving(n_layers: int):
    from repro_torch.core.llama_graph import LlamaSpec, init_llama_tensors
    from repro_torch import kernels
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
    wrappers = [getattr(kernels, name) for name in KERNELS]
    for fn in wrappers:
        fn.launches = fn.calls = 0
    t0 = time.perf_counter()
    done = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in zip(KERNELS, wrappers)}
    assert all(fn.calls == fn.launches for fn in wrappers), [
        (fn.calls, fn.launches) for fn in wrappers]
    prefills, decodes = sched.stats.prefills, dec.decode_calls
    per_call = 7 * n_layers + 1
    assert len(done) == len(lengths), done
    for req in done:
        assert len(req.generated) == 8, (req.rid, req.generated)
        assert all(0 <= t < VOCAB for t in req.generated)
    assert launches["chunked_matmul"] == per_call * (prefills + decodes), (
        launches, prefills, decodes)
    assert launches["paged_attention"] == n_layers * decodes, launches
    assert launches["flash_attention"] == n_layers * prefills, launches
    log(f"served {len(done)} requests in {wall:.2f} s: ticks "
        f"{sched.stats.ticks}, prefills {prefills}, decode "
        f"ticks {decodes}, preemptions {sched.stats.preemptions}")
    log(f"launches: chunked_matmul {launches['chunked_matmul']} = "
        f"{per_call} x {prefills + decodes} run_pipeline calls, "
        f"paged_attention {launches['paged_attention']} = {n_layers} x "
        f"{decodes} decode ticks, flash_attention "
        f"{launches['flash_attention']} = {n_layers} x {prefills} prefills")
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
    walls = []
    for _ in range(5):  # decode returns after the logits' copy to the host
        t0 = time.perf_counter()
        last = dec.decode([0, 1, 2], last)
        walls.append((time.perf_counter() - t0) * 1e3)
    log(f"decode tick (B=3, bucket 4) host wall without the profiler: "
        f"median of 5 {statistics.median(walls):.2f} ms (min "
        f"{min(walls):.2f}, max {max(walls):.2f})")
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
    log(f"one decode tick (B=3, bucket 4) under the profiler: wall "
        f"{wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms, idle share "
        f"{1 - busy / wall_us:.3f}; against the unprofiled median wall "
        f"{1 - busy / 1e3 / statistics.median(walls):.3f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
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

    card = timed("phase 1", phase_device)
    timed("phase 2", phase_build)
    steps, max_err = timed("phase 3 (K1)", phase_kernels)
    step, prefill = steps[1], steps[PREFILL_M]
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    _, attn_step, attn_err = timed("phase 3 (K2, K3)",
                                   phase_attention_kernels, flush)
    del flush
    timed("phase 4", phase_engine_parity)
    launches = timed("phase 5", phase_serving, N_LAYERS)
    log("kernels: K1 chunked_matmul: ok, K2 paged_attention: ok, "
        "K3 flash_attention: ok")
    log(f"total wall {time.perf_counter() - t_all:.1f} s")
    kernels = [{
        "name": "chunked_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/chunked_matmul.cu",
        "replaces": "src/repro/kernels/chunked_matmul.py:42",
        "launches": launches["chunked_matmul"], "max_abs_err": max_err,
        "ms": step["kernel_ms"], "plain_ms": step["plain_ms"],
        "bound_ms": step["bound_ms"], "bound_by": step["bound_by"],
        "library_ms": step["library_ms"],
        "prefill_ms": prefill["kernel_ms"],
        "prefill_library_ms": prefill["library_ms"],
        "prefill_bound_ms": prefill["bound_ms"],
        "times_are": f"one decode step's {sum(STEP_COUNTS.values())} GEMMs "
                     f"at M=1 (prefill_*: one {PREFILL_M}-token prefill's), "
                     f"summed from per-shape medians"}]
    for name, tpu_line, what in (
            ("paged_attention", "src/repro/kernels/paged_attention.py:80",
             "one decode tick"),
            ("flash_attention", "src/repro/kernels/flash_attention.py:72",
             "one prefill")):
        r = attn_step[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": tpu_line, "launches": launches[name],
            "max_abs_err": attn_err[name],
            "ms": N_LAYERS * r["kernel_ms"],
            "plain_ms": N_LAYERS * r["plain_ms"],
            "bound_ms": N_LAYERS * r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": N_LAYERS * r["library_ms"],
            **({"bound_f32_fma_ms": N_LAYERS * r["bound_f32_fma_ms"]}
               if "bound_f32_fma_ms" in r else {}),
            "plan": r["plan"],
            "times_are": f"{what}'s {N_LAYERS} launches at {r['shape']}, "
                         f"{N_LAYERS} x the per-launch median"})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
