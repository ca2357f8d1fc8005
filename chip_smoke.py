#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a) and the CUDA
toolkit's ``nvcc``.  It builds every hand-written kernel from the sources in
this checkout, holds each against its plain PyTorch version on the card
(K1 also in the planner's column layouts and at one shard's strided
slices, K2 and K3 also over head_major and pos_major caches, K3 also with
the suffix prefill's causal offset), runs the engine at Llama-3-8B width
on the card against the same engine on the CPU (depth 2: the reference's
planned defaults with a batched decoder and a suffix session over a
cached prefix, the column layouts under every forced cache layout, int8
and nf4 payloads through the accuracy gate, the planner's chunk size, the
unplanned engine, paged residency under a budget in pinned host memory
and on disk, ``precision="auto"`` under it, and 2 and 4 shards in memory
and paged), then serves at full width and depth under the reference's
defaults (``row2col="auto"``, ``cache_layout="auto"``) through
``ContinuousBatcher`` → ``BatchedDecoder`` → ``RelationalEngine``: a few
cold requests (phase 5), chatbot traffic over a 448-token shared prefix
through the prefix cache in both bind modes with a metrics registry
attached (phase 6), the cold requests again with the weight tables paged
from pinned host memory through a 16 GiB working set (phase 7), and again
with 2 shards (phase 8), and last through the HTTP server with a tracer,
a metrics registry and the drift watchdog (phase 9: eight concurrent SSE
streams through a page pool that forces preemption, shared-prefix traffic,
the flight recorder's ``/debug/*`` endpoints, and the same streams again
untraced for the tracer's cost).  Each serving run checks that every GEMM
went through K1 ``chunked_matmul`` (once a shard at a sharded site), every
decode attention (and one-token suffix) through K2 ``paged_attention``
and every prefill attention (cold, or a suffix over a cached prefix)
through K3 ``flash_attention``; phase 6 also checks the hits, the metrics
and the tokens against a decoder without the cache; phases 7 and 8 hold
one fixed prompt's logits to phase 5's; phase 9 holds the streams' tokens
to ``generate`` and every flight-recorded tick's coverage to at least 0.9.
Any failure exits non-zero.  The last line is ``{"ok": true, "device": {...}}``; the line before it lists
the kernels with their launches, errors and times (the per-shape times
are printed in phase 3), and rows for K1's column layouts and shard
slices and K2/K3 over the planned cache layout.
"""

from __future__ import annotations

import asyncio
import contextlib
import gc
import importlib
import json
import math
import shutil
import statistics
import subprocess
import sys
import threading
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
# K3 in the prefix cache's suffix prefill: (T new tokens, q_offset cached
# rows) over the same cache, the chatbot shape (a 448-token shared prefix)
FLASH_SUFFIX = [(32, 448), (16, 448), (48, 448)]
# the shapes the kernels JSON line reports: one decode tick of phase 5's
# mixed batch, one prefill of a 64-token prompt, one 32-token suffix
# prefill over a 448-row prefix (32 launches each)
PAGED_STEP, FLASH_STEP, SUFFIX_STEP = (4, [33, 72, 100, 512]), 64, (32, 448)
# phase 6: chatbot traffic with a long shared system prompt — one donor of
# a 448-token prefix (28 blocks of 16) plus 16 tokens, then five requests
# of the same prefix plus unique tails, 8 new tokens each
SHARED_PREFIX, DONOR_TAIL, HIT_TAILS, NEW_TOKENS = 448, 16, (1, 8, 16, 32,
                                                             48), 8
# the sweeps of tests/test_kernels.py
PAGED_SWEEP = [[5, 17, 32], [1, 1, 1], [32, 8, 24]]
FLASH_SWEEP = [(32, 32, 16, True), (64, 64, 32, True), (32, 64, 16, False),
               (128, 128, 64, True)]
KERNELS = ("chunked_matmul", "paged_attention", "flash_attention")
# phase 4's disk cold stores (build/ is gitignored)
COLD_DIR = ROOT / "build" / "pager_cold"
# the TPU kernel each replaces (the function reaching pl.pallas_call)
REPLACES = {"chunked_matmul": "src/repro/kernels/chunked_matmul.py:42",
            "paged_attention": "src/repro/kernels/paged_attention.py:80",
            "flash_attention": "src/repro/kernels/flash_attention.py:72"}
# K1's column-layout sites at Llama-3-8B widths, (H, K, Nh): Q as
# COL_CHUNK_HEADS, one [4096, 128] block a head; o, W1/W3 and lm_head as
# COL_CHUNK; and their launches in one decode step or prefill (the
# planner's decisions at these widths: Q, o, W1, W3 and lm_head go to the
# column layouts, K, V and W2 stay row-chunked)
COL_SITES = {"Q (COLH)": (32, 4096, 128), "o": (1, 4096, 4096),
             "W1/W3": (1, 4096, 14336), "lm_head": (1, 4096, 128256)}
COL_COUNTS = {"Q (COLH)": N_LAYERS, "o": N_LAYERS, "W1/W3": 2 * N_LAYERS,
              "lm_head": 1}
COL_M = (1, 4, 64)
# K1 at one shard's slices (the planner shards every one of the 225 matmul
# sites at Llama-3-8B widths): row-parallel sites (K, V, W2 row
# tables) slice the reduction key, so a shard's x and W are [*, K/N] views
# at the full K's row stride; column-parallel sites (o, W1/W3, lm_head
# COL_CHUNK) slice the output chunks, [K, Nh/N] views at the full Nh's
# stride; head-parallel Q (COL_CHUNK_HEADS) takes H/N whole head blocks.
# label: (layout, weight shape, launches a decode step)
SHARD_SITES = {"K/V row": ("row", (1024, 4096), 2 * N_LAYERS),
               "W2 row": ("row", (4096, 14336), N_LAYERS),
               "o col": ("col", (1, 4096, 4096), N_LAYERS),
               "W1/W3 col": ("col", (1, 4096, 14336), 2 * N_LAYERS),
               "lm_head col": ("col", (1, 4096, 128256), 1),
               "Q colh": ("colh", (32, 4096, 128), N_LAYERS)}
SHARD_NS, SHARD_M = (2, 4), (1, 64)
# phase 4's budget for its paged cases: below the depth-2 decode plan's
# working set (about 6 GB: the vocabulary and lm_head tables, 2.1 GB
# each, and two layers); phase 7's, against a 32-layer decode step's 30.0
# GB of GEMM weights and the 2.1 GB vocabulary table
PHASE4_BUDGET, PAGED_BUDGET = 2 << 30, 16 << 30
# phase 7 keeps this much host memory free beside its pinned cold store
HOST_MARGIN = 8 << 30
# phases 5, 7, 8 and 9: the fixed prompt whose prefill and 4 decode steps
# are compared across engines
FIXED_PROMPT_SEED, FIXED_STEPS = 7, 4
# phase 9: HTTP serving.  Eight concurrent streams of 20-22-token prompts
# and 12 new tokens (3 pages of 8 tokens at admission, 5 at the end),
# through max_batch=3 and a pool of 12 pages, which three lockstep streams
# outgrow: the batcher must preempt.  Then chatbot traffic over a shared
# 64-token prefix: a donor, then three hits (a one-token suffix on K2,
# longer ones on K3 with its offset), each of which fits the pool alone
# (the scheduler spins on a request that can never fit).  The drift
# watchdog checks every 8 ticks; the flight ring keeps every tick.
HTTP_PAGE, HTTP_POOL, HTTP_STREAMS, HTTP_NEW = 8, 12, 8, 12
HTTP_SHARED, HTTP_HIT_TAILS, HTTP_DRIFT_EVERY = 64, (1, 5, 8), 8
HTTP_TIMEOUT_S = 600


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
    for T, off in FLASH_SUFFIX:
        # a suffix prefill over a cached prefix: query row t at position
        # off + t sees keys s <= off + t; the library is SDPA with the same
        # boolean mask (its is_causal is top-left aligned); the bound counts
        # the off + T K/V rows the rows read
        q = torch.randn(T, H, d, generator=gen,
                        device=dev).permute(1, 0, 2)[None]
        k = torch.randn(S, Hkv, d, generator=gen,
                        device=dev).permute(1, 0, 2)[None]
        v = torch.randn(S, Hkv, d, generator=gen,
                        device=dev).permute(1, 0, 2)[None]
        mask = (torch.arange(S, device=dev)[None, :]
                <= torch.arange(T, device=dev)[:, None] + off)
        pairs = sum(min(off + t + 1, S) for t in range(T))
        plan = K3._plan(1, T, S, H, Hkv, d, torch.float32, sms)
        r = row("flash_attention", f"T={T} offset={off} S={S}",
                f"{plan.warps} warps on {plan.heads} heads x {plan.rows} "
                f"rows, {plan.bk}-row K/V tiles, "
                f"{'balanced, ' if plan.balance else ''}{plan.blocks} blocks",
                lambda: flash_attention(q, k, v, True, q_offset=off),
                lambda: ref.flash_attention(q, k, v, True, q_offset=off),
                lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True),
                4 * (2 * T * H * d + 2 * min(off + T, S) * Hkv * d),
                4 * H * d * pairs, TENSOR_PEAKS[torch.float32])
        if (T, off) == SUFFIX_STEP:
            step["suffix"] = r
    for name, r in step.items():
        what = {"paged_attention": "decode tick",
                "flash_attention": "prefill",
                "suffix": "suffix prefill"}[name]
        log(f"one {what}'s {N_LAYERS} launches at {r['shape']}: kernel "
            f"{N_LAYERS * r['kernel_ms']:.3f} ms, plain "
            f"{N_LAYERS * r['plain_ms']:.3f} ms, library "
            f"{N_LAYERS * r['library_ms']:.3f} ms, bound "
            f"{N_LAYERS * r['bound_ms']:.3f} ms")
    return rows, step, err


def phase_col_kernels(flush):
    """K1 in the planner's column layouts (ROW2COL) at Llama-3-8B's column
    sites: Q as COL_CHUNK_HEADS [32 x (4096 -> 128)], o, W1/W3 and lm_head
    as COL_CHUNK, at decode M = 1, 4 and prefill M = 64."""
    from repro_torch.kernels import chunked_matmul, ref
    from repro_torch.kernels._build import sm_count
    K1 = importlib.import_module("repro_torch.kernels.chunked_matmul")
    log("== phase 3: K1 chunked_matmul in the column layouts against its "
        "plain version")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    max_err, rows = 0.0, []
    for label, (H, K, Nh) in COL_SITES.items():
        w = torch.randn(H, K, Nh, generator=gen, device=dev).mul_(K ** -0.5)
        for m in COL_M:
            x = torch.randn(m, K, generator=gen, device=dev)
            got = chunked_matmul(x, w, layout="col")
            want = ref.chunked_matmul(x, w, "col")
            again = chunked_matmul(x, w, layout="col")
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
            assert torch.equal(got, again), f"{label} M={m}: not repeatable"
            err = (got - want).abs().max().item()
            max_err = max(max_err, err)
            plan = K1._plan_col(m, H, Nh, K, x.dtype, K1._aligned_col(x, w),
                                sm_count(dev))
            n = H * Nh
            bound, by = _bound(4 * (m * K + n * K + m * n), 2 * m * n * K)
            row = {
                "site": label, "M": m, "H": H, "K": K, "Nh": Nh,
                "kernel_ms": time_ms(
                    lambda: chunked_matmul(x, w, layout="col"), flush),
                "plain_ms": time_ms(
                    lambda: ref.chunked_matmul(x, w, "col"), flush),
                "library_ms": time_ms(lambda: torch.matmul(x, w), flush),
                "bound_ms": bound, "bound_by": by, "max_abs_err": err,
                "plan": f"{plan.regime} tile {plan.tile} splits "
                        f"{plan.splits} ({plan.blocks} blocks)"}
            rows.append(row)
            log(f"  {label:9s} M={m:3d} H={H:2d} K={K} Nh={Nh:6d}  kernel "
                f"{row['kernel_ms']:.4f} ms  plain {row['plain_ms']:.4f} ms "
                f" library {row['library_ms']:.4f} ms  bound {bound:.4f} ms "
                f"({by})  max|err| {err:.2e}  {row['plan']}")
        del w
    steps = {}
    for m in COL_M:
        what = "prefill" if m == PREFILL_M else "decode step"
        step = {key: sum(r[key] * COL_COUNTS[r["site"]] for r in rows
                         if r["M"] == m)
                for key in ("kernel_ms", "plain_ms", "library_ms",
                            "bound_ms")}
        step["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes"
                                           for r in rows if r["M"] == m)
                            else "operations")
        steps[m] = step
        log(f"one {what}'s {sum(COL_COUNTS.values())} column-layout GEMMs "
            f"at M={m}: kernel {step['kernel_ms']:.3f} ms, plain "
            f"{step['plain_ms']:.3f} ms, library {step['library_ms']:.3f} ms,"
            f" bound {step['bound_ms']:.3f} ms ({step['bound_by']})")
    return steps, max_err


def _shard_slices(layout, w, x, n):
    """The N shards' (x, w) views of one site, as the shard workers launch
    them: row sites slice the reduction key of both (K/N columns at the full
    row stride), col sites the output columns of W, colh sites W's head
    blocks."""
    if layout == "row":
        k = w.shape[1] // n
        return [(x[:, s * k:(s + 1) * k], w[:, s * k:(s + 1) * k])
                for s in range(n)]
    if layout == "col":
        c = w.shape[2] // n
        return [(x, w[:, :, s * c:(s + 1) * c]) for s in range(n)]
    h = w.shape[0] // n
    return [(x, w[s * h:(s + 1) * h]) for s in range(n)]


def phase_shard_kernels(flush):
    """K1 at one shard's shapes for N = 2 and 4: every shard's launch held
    against its plain version, shard 0's timed on the strided views the
    workers pass and on a contiguous copy of the same slice (what the
    wider row stride costs), beside ``torch.matmul`` on the views and the
    bytes bound, at decode M = 1 and prefill M = 64."""
    from repro_torch.kernels import chunked_matmul, ref
    log("== phase 3: K1 chunked_matmul at one shard's strided slices against "
        "its plain version")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    max_err, rows = 0.0, []
    for label, (layout, shape, _) in SHARD_SITES.items():
        K = shape[1]
        w = torch.randn(*shape, generator=gen, device=dev).mul_(K ** -0.5)
        kw = {} if layout == "row" else {"layout": "col"}
        for n in SHARD_NS:
            for m in SHARD_M:
                x = torch.randn(m, K, generator=gen, device=dev)
                shards = _shard_slices(layout, w, x, n)
                for xs, ws in shards:
                    got = chunked_matmul(xs, ws, **kw)
                    want = ref.chunked_matmul(xs, ws, layout if layout ==
                                              "row" else "col")
                    torch.cuda.synchronize()
                    torch.testing.assert_close(got, want, rtol=1e-4,
                                               atol=1e-4)
                    err = (got - want).abs().max().item()
                    max_err = max(max_err, err)
                xs, ws = shards[0]
                wc = ws.contiguous()
                ks = xs.shape[1]
                ns = ws.shape[0] if layout == "row" else ws.shape[0] * \
                    ws.shape[2]
                bound, by = _bound(4 * (m * ks + ns * ks + m * ns),
                                   2 * m * ns * ks)
                lib = ((lambda: torch.matmul(xs, ws.T)) if layout == "row"
                       else (lambda: torch.matmul(xs, ws)))
                row = {
                    "site": label, "N": n, "M": m, "K": ks, "out": ns,
                    "w_row_stride": ws.stride(-2),
                    "kernel_ms": time_ms(
                        lambda: chunked_matmul(xs, ws, **kw), flush),
                    "contiguous_ms": time_ms(
                        lambda: chunked_matmul(xs, wc, **kw), flush),
                    "plain_ms": time_ms(
                        lambda: ref.chunked_matmul(
                            xs, ws, "row" if layout == "row" else "col"),
                        flush),
                    "library_ms": time_ms(lib, flush),
                    "bound_ms": bound, "bound_by": by}
                rows.append(row)
                log(f"  {label:11s} N={n} M={m:3d} shard K={ks:5d} out="
                    f"{ns:6d} W row stride {row['w_row_stride']:6d}  kernel "
                    f"{row['kernel_ms']:.4f} ms (contiguous copy "
                    f"{row['contiguous_ms']:.4f})  plain {row['plain_ms']:.4f}"
                    f" ms  library {row['library_ms']:.4f} ms  bound "
                    f"{bound:.4f} ms ({by}); kernel / bound "
                    f"{row['kernel_ms'] / bound:.2f}, contiguous / bound "
                    f"{row['contiguous_ms'] / bound:.2f}")
                del wc
        del w
    steps = {}
    for n in SHARD_NS:
        for m in SHARD_M:
            sel = [r for r in rows if r["N"] == n and r["M"] == m]
            # one decode step (or prefill): every sharded site's N launches
            step = {key: sum(n * SHARD_SITES[r["site"]][2] * r[key]
                             for r in sel)
                    for key in ("kernel_ms", "contiguous_ms", "plain_ms",
                                "library_ms", "bound_ms")}
            step["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes"
                                               for r in sel) else
                                "operations")
            steps[(n, m)] = step
            what = "prefill" if m == PREFILL_M else "decode step"
            log(f"one {what}'s 225 sharded GEMMs at N={n}, M={m} "
                f"({n} launches a site): kernel {step['kernel_ms']:.3f} ms "
                f"(contiguous copies {step['contiguous_ms']:.3f}), plain "
                f"{step['plain_ms']:.3f} ms, library "
                f"{step['library_ms']:.3f} ms, bound {step['bound_ms']:.3f} "
                f"ms ({step['bound_by']})")
    return steps, max_err


def phase_quant_k1(flush):
    """What a quantised table costs K1 today: the executor builds the f32
    right input from the codes (the dequant projection, ``qchunk * scale``
    or ``nf4_dequant(qchunk) * scale``) on every call, then runs K1 on it.
    Timed at W1's row table (14336 x 4096, chunk 64) at M = 1 against K1
    on the resident f32 table."""
    from repro_torch.kernels import chunked_matmul
    from repro_torch.quant.codecs import CODECS
    log("== phase 3: K1 over a quantised table (dequantise, then K1)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    n, k, cs = 14336, 4096, 64
    w = torch.randn(n, k // cs, cs, generator=gen, device=dev) * k ** -0.5
    x = torch.randn(1, k, generator=gen, device=dev)
    f32 = time_ms(lambda: chunked_matmul(x, w.view(n, k)), flush)
    log(f"  W1 {n}x{k} M=1 f32 table: K1 {f32:.4f} ms")
    out = {"f32_ms": f32}
    for name in ("int8", "nf4"):
        codec = CODECS[name]
        codes, scales = codec.quantise(w)
        deq = time_ms(lambda: codec.dequantise(codes, scales), flush)
        both = time_ms(lambda: chunked_matmul(
            x, codec.dequantise(codes, scales).view(n, k)), flush)
        err = (chunked_matmul(x, codec.dequantise(codes, scales).view(n, k))
               - chunked_matmul(x, w.view(n, k))).abs().max().item()
        out[name] = {"dequant_ms": deq, "dequant_and_k1_ms": both,
                     "max_abs_err_vs_f32": err}
        log(f"  W1 {name}: dequantise {deq:.4f} ms, dequantise + K1 "
            f"{both:.4f} ms ({both / f32:.2f}x the f32 table's K1); "
            f"max|Δ| against f32 {err:.3e}")
    del w, codes, scales
    return out


def phase_cache_layout_attention(flush):
    """K2 and K3 over caches stored in the planner's other key orders, at
    phase 5's step shapes, viewed as the executor views them: a
    ``head_major`` cache [(B,) Hkv, S, d] is one S-row page a sequence (a
    strided view, no copy); a ``pos_major`` one [(B,) S, nc, Hkv, cs] at
    chunk 64 splits a head's 128 values over two chunks, so it is first
    gathered into a contiguous [(B,) S, Hkv, d] copy (timed apart)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    from repro_torch.kernels import flash_attention, paged_attention, ref
    log("== phase 3: K2 and K3 over the head_major and pos_major cache "
        "orders")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    H, Hkv, d, S = N_HEADS, N_KV, HEAD_DIM, MAX_LEN
    cs = 64
    B, lens = PAGED_STEP
    T = FLASH_STEP
    out = {}
    for layout in ("head_major", "pos_major"):
        if layout == "head_major":
            ck = torch.randn(B, Hkv, S, d, generator=gen, device=dev)
            cv = torch.randn(B, Hkv, S, d, generator=gen, device=dev)

            def rows(c):  # the executor's view: [B, S, Hkv, d], strided
                return c.permute(0, 2, 1, 3)
        else:
            ck = torch.randn(B, S, d // cs, Hkv, cs, generator=gen,
                             device=dev)
            cv = torch.randn(B, S, d // cs, Hkv, cs, generator=gen,
                             device=dev)

            def rows(c):  # the executor's gather: a contiguous copy
                return c.permute(0, 1, 3, 2, 4).reshape(c.shape[0], S, Hkv,
                                                        d)
        kr, vr = rows(ck), rows(cv)
        dense_k, dense_v = kr.contiguous(), vr.contiguous()
        q = torch.randn(B, H, d, generator=gen, device=dev)
        pt = torch.arange(B, dtype=torch.int32, device=dev).view(B, 1)
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        mask = (torch.arange(S, device=dev)[None, :] < ln[:, None])[
            :, None, None, :]
        live = sum(lens)
        k2 = {
            "kernel": lambda: paged_attention(q, kr, vr, pt, ln),
            "plain": lambda: ref.paged_attention(q, kr, vr, pt, ln),
            "library": lambda: sdpa(q[:, :, None], dense_k.transpose(1, 2),
                                    dense_v.transpose(1, 2), attn_mask=mask,
                                    enable_gqa=True)[:, :, 0],
            "bytes": 4 * (2 * live * Hkv * d + 2 * B * H * d),
            "flops": 4 * H * d * live, "rate": PEAKS[1],
            "shape": f"B={B} len={lens}"}
        qf = torch.randn(T, H, d, generator=gen,
                         device=dev).permute(1, 0, 2)[None]

        def heads(c):  # sequence 0's [1, Hkv, S, d]
            return rows(c[:1]).transpose(1, 2)
        hk, hv = heads(ck), heads(cv)
        k3 = {
            "kernel": lambda: flash_attention(qf, hk, hv, True),
            "plain": lambda: ref.flash_attention(qf, hk, hv, True),
            "library": lambda: sdpa(qf, hk, hv, is_causal=True,
                                    enable_gqa=True),
            "bytes": 4 * (2 * T * H * d + 2 * T * Hkv * d),
            "flops": 4 * H * d * sum(t + 1 for t in range(T)),
            "rate": TENSOR_PEAKS[torch.float32], "shape": f"T={T} S={S}"}
        for name, c in (("paged_attention", k2), ("flash_attention", k3)):
            got, want = c["kernel"](), c["plain"]()
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
            err = (got - want).abs().max().item()
            bound, by = _bound(c["bytes"], c["flops"], c["rate"])
            r = {"shape": c["shape"], "max_abs_err": err,
                 "kernel_ms": time_ms(c["kernel"], flush),
                 "plain_ms": time_ms(c["plain"], flush),
                 "library_ms": time_ms(c["library"], flush),
                 "bound_ms": bound, "bound_by": by}
            if layout == "pos_major":
                # the executor's gather of K and V before each launch, timed
                # apart from the kernel (which reads the gathered copies)
                r["gather_ms"] = time_ms(
                    lambda: (rows(ck), rows(cv)) if name ==
                    "paged_attention" else (heads(ck), heads(cv)), flush)
            out[(name, layout)] = r
            log(f"  {name} {layout:10s} {c['shape']:24s} kernel "
                f"{r['kernel_ms']:.4f} ms"
                + (f" (+ the gather {r['gather_ms']:.4f} ms)"
                   if "gather_ms" in r else "")
                + f"  plain {r['plain_ms']:.4f} ms  library "
                f"{r['library_ms']:.4f} ms  bound {bound * 1e3:.3f} us "
                f"({by})  max|err| {err:.2e}")
        del ck, cv, kr, vr, hk, hv, dense_k, dense_v
    return out


def _assert_logits(lg_gpu, lg_cpu):
    """The GPU-vs-CPU limits: logits within 1e-3, greedy tokens equal
    where the CPU's top-2 margin exceeds 1e-3."""
    np.testing.assert_allclose(lg_gpu, lg_cpu, rtol=1e-3, atol=1e-3)
    for g, c in zip(np.atleast_2d(lg_gpu), np.atleast_2d(lg_cpu)):
        top2 = np.sort(c)[-2:]
        if top2[1] - top2[0] > 1e-3:
            assert int(np.argmax(g)) == int(np.argmax(c)), (g, c)
    return float(np.abs(lg_gpu - lg_cpu).max())


def _engine_pair(spec, params, **knobs):
    """The same engine on the card and on the CPU (the port's reference):
    ``{device: engine}``.  ``accuracy_budget`` goes to the card's engine
    only: the gate builds a second, f32 engine and changes no plan.
    ``disk_dir=True`` gives each engine a cold-store directory of its own
    under the checkout's ``build/``."""
    from repro_torch.serving.engine import RelationalEngine
    gate = {"accuracy_budget": knobs.pop("accuracy_budget")} \
        if "accuracy_budget" in knobs else {}
    disk = knobs.pop("disk_dir", False)
    engines = {}
    for d in ("cuda", "cpu"):
        extra = dict(gate if d == "cuda" else {})
        if disk:
            extra["disk_dir"] = str(COLD_DIR / d)
        engines[d] = RelationalEngine(spec, params, max_len=64, device=d,
                                      **dict(dict(chunk_size=64), **knobs),
                                      **extra)
    return engines


def _pagers(eng):
    """The engine's pagers: the coordinator's and each shard worker's."""
    workers = eng.shard_pool.workers if eng.shard_pool is not None else []
    return [p for p in [eng.pager] + [w.pager for w in workers]
            if p is not None]


def _gets_a_scan(eng, table: str) -> int:
    """Pager gets a Scan of ``table`` makes in ``eng``: two for a quantised
    table (its codes and its scales), one for a paged table, none for the
    rest.  Read at each Scan: plans compiled later register more tables."""
    workers = eng.shard_pool.workers if eng.shard_pool is not None else []
    specs = [eng._quant_specs] + [w._quant_specs for w in workers
                                  if w.pager is not None]
    if any(table in spec for spec in specs):
        return 2
    return int(any(table in p._cold for p in _pagers(eng)))


@contextlib.contextmanager
def _counting_scans(eng):
    """Count the executor's Scans of the tables ``eng``'s pagers serve
    (weighted by the gets each makes) while the block runs: an independent
    count of what the pagers must serve.  The executor recurses through
    its module's ``execute``."""
    import repro_torch.core.executor as ex
    from repro_torch.core.relational import Scan
    inner, count, lock = ex.execute, [0], threading.Lock()

    def counting(node, env, memo=None, scalars=None, tracer=None):
        if isinstance(node, Scan):
            gets = _gets_a_scan(eng, node.table)
            with lock:
                count[0] += gets
        return inner(node, env, memo, scalars, tracer)

    ex.execute = counting
    try:
        yield count
    finally:
        ex.execute = inner


def _shard_counts(eng):
    """(sites fanned out, per-shard plan runs) of the engine's pool so far:
    a site runs once a shard, on as many shards as its key range splits
    into (the planner clamps N to the key's size)."""
    pool = eng.shard_pool
    if pool is None:
        return 0, 0
    return pool.stats.sites, int(sum(
        w.metrics.counter("shard_worker_runs_total").value
        for w in pool.workers))


def _pager_gets(eng) -> int:
    return sum(p.stats.hits + p.stats.prefetch_hits + p.stats.misses
               for p in _pagers(eng))


def _parity_session(engines, n_layers):
    """A 32-token prefill and 4 decode steps, the card's token fed to both
    engines: max |Δlogit|, the tokens, and the launches on the card checked
    (K1 7·L + 1 a pipeline call and N − 1 more a sharded site, one
    attention kernel a layer a call).  Under paged residency the pagers'
    hits + prefetch hits + misses on the card must equal the weight Scans
    the plans issued; returns those stats too."""
    from repro_torch.kernels import (chunked_matmul, flash_attention,
                                     paged_attention)
    gpu = engines["cuda"]
    pool = gpu.shard_pool
    shard0 = _shard_counts(gpu)
    paged = bool(_pagers(gpu))
    gets = _pager_gets(gpu)
    before = (chunked_matmul.launches, paged_attention.launches,
              flash_attention.launches)
    prompt = [int(t) for t in
              np.random.default_rng(1).integers(0, VOCAB, 32)]
    scans = 0

    def on(d, fn, *args):
        nonlocal scans
        if d != "cuda" or not paged:
            return fn(*args)
        with _counting_scans(gpu) as count:
            out = fn(*args)
        scans += count[0]
        return out

    sess = {d: on(d, e.start_session, prompt) for d, e in engines.items()}
    max_diff, gpu_toks, cpu_toks = 0.0, [], []
    for step in range(5):
        if step:
            for d in engines:
                # teacher-force the GPU's token so both see one sequence
                sess[d]["tok"] = gpu_toks[-1]
                on(d, engines[d].session_step, sess[d])
        lg_gpu, lg_cpu = sess["cuda"]["logits"], sess["cpu"]["logits"]
        max_diff = max(max_diff, _assert_logits(lg_gpu, lg_cpu))
        gpu_toks.append(int(np.argmax(lg_gpu)))
        cpu_toks.append(int(np.argmax(lg_cpu)))
    launched = (chunked_matmul.launches - before[0],
                paged_attention.launches - before[1],
                flash_attention.launches - before[2])
    sharded, runs = (a - b for a, b in zip(_shard_counts(gpu), shard0))
    if pool is not None:
        assert sharded > 0, "no site was sharded"
    # each sharded site runs K1 once a shard in place of once
    assert launched == (5 * (7 * n_layers + 1) + runs - sharded,
                        4 * n_layers, n_layers), (launched, sharded, runs)
    paging = None
    if paged:
        gets = _pager_gets(gpu) - gets
        assert gets == scans, (gets, scans)
        paging = {"scans": scans,
                  "pagers": [dict(vars(p.stats), budget=p.budget)
                             for p in _pagers(gpu)]}
        # the reference's pager overshoots its budget by at most one
        # table: when what it holds cannot be evicted (a prefetched entry,
        # here the 2.1 GB vocabulary, fills most of 2 GiB) a miss still
        # pages in
        for p in _pagers(gpu):
            largest = max((math.prod(c.shape) * c.dtype.itemsize
                           for c in p._cold.values()), default=0)
            assert p.stats.peak_bytes <= p.budget + largest, vars(p.stats)
    return max_diff, gpu_toks, cpu_toks, paging, (sharded, runs)


def _code_mismatches(engines):
    """Codes and scales of every quantised table built on the card against
    the CPU's: (mismatching elements, elements compared).  Paged engines
    hold them in their cold stores."""
    bad = total = 0
    gpu, cpu = engines["cuda"], engines["cpu"]
    if gpu.pager is not None:
        for name in gpu.pager._cold:
            if name.endswith(("::q", "::scale")):
                got = gpu.pager.cold_tensor(name)
                ref = cpu.pager.cold_tensor(name)
                bad += int((got != ref).sum())
                total += ref.numel()
        return bad, total
    for name, t in gpu.env_base.items():
        if name.endswith(("__int8", "__nf4")):
            for c, arr in t.cols.items():
                ref = cpu.env_base[name].cols[c]
                bad += int((arr.cpu() != ref).sum())
                total += ref.numel()
    return bad, total


# phase 4's planned cases: the reference's defaults, every forced cache
# layout under the column layouts, both codecs through the accuracy gate,
# and the planner's chunk size
PLANNED_CASES = [
    ("row2col=auto cache_layout=auto (defaults)", {}),
    ("row2col=col cache_layout=row_chunk",
     dict(row2col="col", cache_layout="row_chunk")),
    ("row2col=col cache_layout=head_major",
     dict(row2col="col", cache_layout="head_major")),
    ("row2col=col cache_layout=pos_major",
     dict(row2col="col", cache_layout="pos_major")),
    ("precision=int8 accuracy_budget=1000",
     dict(precision="int8", accuracy_budget=1e3)),
    ("precision=nf4 accuracy_budget=1000",
     dict(precision="nf4", accuracy_budget=1e3)),
    ("chunk_size=auto", dict(chunk_size="auto")),
]


def _plan_summary(eng) -> str:
    plan = eng.decode_pipe.layout_plan
    if plan is None:
        return "unplanned"
    layouts = {}
    for d in plan.decisions:
        layouts[d.layout] = layouts.get(d.layout, 0) + 1
    return (f"chunk {eng.cs}, {len(plan.decisions)} matmul sites "
            f"{layouts}, cache {eng.cache_layout}, "
            f"{len(plan.precision_decisions)} quantised tables")


# phase 4's paged and sharded cases: a budget below the decode
# plan's working set with the cold store in pinned host memory and on
# disk, precision="auto" quantising to fit it, and 2 and 4 shards in
# memory and paged
PAGED = dict(residency="paged", budget_bytes=PHASE4_BUDGET)
PAGED_CASES = [
    ("residency=paged, pinned host memory, budget 2 GiB", PAGED),
    ("residency=paged, disk_dir, budget 2 GiB", dict(PAGED, disk_dir=True)),
    ("residency=paged precision=auto, budget 2 GiB",
     dict(PAGED, precision="auto")),
    ("shards=2", dict(shards=2)),
    ("shards=4", dict(shards=4)),
    ("shards=2 residency=paged, budget 2 GiB", dict(PAGED, shards=2)),
    ("shards=4 residency=paged, budget 2 GiB", dict(PAGED, shards=4)),
]


def _working_set(eng) -> int:
    """Stored bytes of the distinct paged tables the decode plan scans."""
    from repro_torch.core.relational import Scan, walk
    names = {n.table for step in eng.decode_pipe.steps
             for n in walk(step.rel.plan) if isinstance(n, Scan)}
    total = 0
    for p in _pagers(eng):
        for name, cold in p._cold.items():
            base = name.split("::")[0]
            if name in names or (base in names and name.endswith(
                    ("::q", "::scale"))):
                total += math.prod(cold.shape) * cold.dtype.itemsize
    return total


def phase_engine_parity():
    import repro_torch.serving.engine as engine_mod
    from repro_torch.core.llama_graph import LlamaSpec, init_llama_params
    from repro_torch.kernels import flash_attention, paged_attention
    from repro_torch.quant.gate import logit_error_between
    log("== phase 4: engine at Llama-3-8B width, depth 2: GPU against CPU")
    spec = LlamaSpec(vocab=VOCAB, d_model=D_MODEL, n_layers=2,
                     n_heads=N_HEADS, n_kv=N_KV, d_ff=D_FF, rope_theta=THETA)
    t0 = time.perf_counter()
    params = init_llama_params(spec, seed=0)
    log(f"numpy weights (seed 0): {time.perf_counter() - t0:.1f} s")
    worst = 0.0
    f32_gpu = None
    shard_launches = {n: 0 for n in SHARD_NS}
    for label, knobs in PLANNED_CASES + PAGED_CASES:
        t0 = time.perf_counter()
        engines = _engine_pair(spec, params, **knobs)
        built = time.perf_counter() - t0
        diff, gpu_toks, cpu_toks, paging, (sites, runs) = _parity_session(
            engines, spec.n_layers)
        worst = max(worst, diff)
        gpu = engines["cuda"]
        log(f"[{label}] {_plan_summary(gpu)}; built in "
            f"{built:.1f} s; prefill T=32 + 4 decode steps: max|Δlogit| GPU "
            f"vs CPU {diff:.3e}; tokens GPU {gpu_toks} CPU {cpu_toks}")
        assert gpu.cache_layout == engines["cpu"].cache_layout
        if gpu.shards > 1:
            shard_launches[gpu.shards] += runs
            log(f"  {gpu.shards} shards on {gpu.shards} CUDA streams: "
                f"{sites} sites fanned out, {runs} K1 launches at shard "
                f"shapes; pool busy {gpu.shard_pool.stats.fanout_s:.3f} s "
                f"summed, {gpu.shard_pool.stats.critical_s:.3f} s critical "
                f"path")
        if paging is not None:
            # precision="auto" quantises until the working set fits
            ws = _working_set(gpu)
            assert ws > PHASE4_BUDGET or knobs.get("precision") == "auto", (
                ws, PHASE4_BUDGET)
            log(f"  paged: decode plan's working set {ws / 1e9:.3f} GB, "
                f"budget {PHASE4_BUDGET / 2**30:.0f} GiB; pager gets = "
                f"weight Scans = {paging['scans']}; stats (coordinator, "
                f"then each shard's pager) {paging['pagers']}")
            assert any(p["evictions"] > 0 for p in paging["pagers"]), paging
        if "precision" in knobs:
            if knobs["precision"] == "auto":
                assert gpu.table_precision_choices, "auto quantised nothing"
                log(f"  precision=auto under the budget quantised "
                    f"{gpu.table_precision_choices}")
            bad, total = _code_mismatches(engines)
            log(f"  codes on the card against the CPU's: {bad} of {total} "
                f"differ" + ("" if not bad else
                             " (held by the logits above instead)"))
            err = logit_error_between(gpu, f32_gpu, [3, 1, 2])
            log(("  accuracy gate passed; " if "accuracy_budget" in knobs
                 else "  ")
                + f"max|Δlogit| against the f32 engine on the probe prompt: "
                f"{err:.4g}")
        if not knobs:
            f32_gpu = gpu
            _parity_batched_and_suffix(engines, spec, engine_mod,
                                       paged_attention, flash_attention)
        for e in engines.values():
            if e.shard_pool is not None:
                e.shard_pool.shutdown()
        del engines, gpu
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(COLD_DIR, ignore_errors=True)
    assert all(shard_launches.values()), shard_launches
    # the unplanned case of the earlier slices
    engines = _engine_pair(spec, params, row2col="off", cache_layout="off")
    diff, gpu_toks, cpu_toks, _, _ = _parity_session(engines, spec.n_layers)
    log(f"[row2col=off cache_layout=off] unplanned: max|Δlogit| GPU vs CPU "
        f"{diff:.3e}; tokens GPU {gpu_toks} CPU {cpu_toks}")
    worst = max(worst, diff,
                _parity_batched_and_suffix(engines, spec, engine_mod,
                                           paged_attention, flash_attention))
    del engines, params, f32_gpu
    gc.collect()
    torch.cuda.empty_cache()
    _release_pinned()
    return worst, shard_launches


def _release_pinned() -> None:
    """Give the pinned host blocks PyTorch keeps cached back to the OS."""
    if hasattr(torch._C, "_host_emptyCache"):
        torch._C._host_emptyCache()


def _parity_batched_and_suffix(engines, spec, engine_mod, paged_attention,
                               flash_attention):
    """A batched decoder (three prompts, four ticks, each pipeline call's
    logits taken from run_pipeline's outputs) and a suffix session over a
    48-token prefix, on the card against the CPU."""
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
    before = (paged_attention.launches, flash_attention.launches)
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
    log(f"  batched decoder, prompts {[len(p) for p in prompts]}, 4 ticks at "
        f"bucket 4 ({engines['cuda'].cache_layout} slot pool): max|Δlogit| "
        f"GPU vs CPU {bdiff:.3e}")
    log(f"  tokens per tick (GPU, CPU) {ticks}")
    decodes = decs["cuda"].decode_calls
    k2 = paged_attention.launches - before[0]
    k3 = flash_attention.launches - before[1]
    assert (k2, k3) == (spec.n_layers * decodes,
                        spec.n_layers * len(prompts)), (k2, k3)
    log(f"  GPU side: paged_attention launches {k2} = {spec.n_layers} x "
        f"{decodes} decode ticks, flash_attention launches {k3} = "
        f"{spec.n_layers} x {len(prompts)} prefills")

    # the prefix cache's suffix session: a 48-token prefix, then 8 suffix
    # tokens over its caches (K3 with q_offset 48), against the CPU port's
    # suffix session and the card's own cold session of all 56 tokens
    rng = np.random.default_rng(5)
    prompt = [int(t) for t in rng.integers(0, VOCAB, 56)]
    suffix = {}
    for d, e in engines.items():
        tables = {k: v for k, v in e.start_session(prompt[:48])[
            "env"].items() if k.startswith(("k_cache", "v_cache"))}
        snap = {k: t.cols[c].clone() for k, t in tables.items()
                for c in t.cols}
        before = (paged_attention.launches, flash_attention.launches)
        suffix[d] = e.start_suffix_session(prompt, 48, tables)["logits"]
        launched = (paged_attention.launches - before[0],
                    flash_attention.launches - before[1])
        assert launched == ((0, spec.n_layers) if d == "cuda" else (0, 0)), (
            d, launched)
        assert all(torch.equal(snap[k], t.cols[c])
                   for k, t in tables.items() for c in t.cols), \
            "the suffix session wrote the prefix's caches"
    sdiff = _assert_logits(suffix["cuda"], suffix["cpu"])
    cdiff = _assert_logits(suffix["cuda"],
                           engines["cuda"].start_session(prompt)["logits"])
    log(f"  suffix session, 48-token prefix + 8 tokens (K3 q_offset 48, "
        f"{spec.n_layers} launches): max|Δlogit| GPU vs CPU "
        f"{sdiff:.3e}, GPU suffix vs GPU cold session {cdiff:.3e}")
    return max(bdiff, sdiff)


def _spec(n_layers: int):
    from repro_torch.core.llama_graph import LlamaSpec
    return LlamaSpec(vocab=VOCAB, d_model=D_MODEL, n_layers=n_layers,
                     n_heads=N_HEADS, n_kv=N_KV, d_ff=D_FF, rope_theta=THETA)


def _serve_cold_requests(eng, tag: str):
    """Phase 5's request set (prompts of 32/64/32/64 tokens, 8 new tokens
    each) through ``ContinuousBatcher(max_batch=3)`` and a
    ``BatchedDecoder(prefix_block=0)``, the plans compiled before the
    requests arrive.  Every kernel's count is zeroed just before the run
    and read just after: K1 7·L + 1 a pipeline call (N − 1 more a sharded
    site), K2 L a decode tick, K3 L a prefill.  Returns the launches, the
    decoder, the KV page table and each request's (TTFT, TPOT) in ms."""
    from repro_torch import kernels
    from repro_torch.serving.kvcache import PagedKVCache, PagedKVConfig
    from repro_torch.serving.scheduler import ContinuousBatcher, Request
    n_layers = eng.spec.n_layers
    kv = PagedKVCache(PagedKVConfig(n_layers=n_layers, n_kv=N_KV,
                                    head_dim=HEAD_DIM, page_size=16,
                                    n_pages=64, max_pages_per_seq=32),
                      max_seqs=4, device="cuda")
    dec = eng.batched_decoder(max_seqs=4, prefix_block=0)

    def prefill(req, seq_id):
        kv.ensure_capacity(seq_id, len(req.context))
        return dec.prefill(req.context, seq_id)

    sched = ContinuousBatcher(kv, prefill, dec.decode, max_batch=3,
                              release_fn=dec.free)
    lengths = (32, 64, 32, 64)
    # compile the plans the run needs before the requests arrive, so
    # TTFT/TPOT are steady state
    t0 = time.perf_counter()
    for n in sorted(set(lengths)):
        _compile_logged(eng, f"prefill T={n}", eng._prefill_pipe, n)
    for bucket in (1, 2, 4):
        _compile_logged(eng, f"batched decode B={bucket}",
                        eng._batched_decode_pipe, bucket)
    log(f"{tag} plans compiled (prefill T={sorted(set(lengths))}, batch "
        f"buckets 1, 2, 4) in {time.perf_counter() - t0:.2f} s; memory "
        f"allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    rng = np.random.default_rng(2)
    for rid, n in enumerate(lengths):
        sched.submit(Request(rid=rid, prompt=[int(t) for t in
                                              rng.integers(0, VOCAB, n)],
                             max_new_tokens=8))
    wrappers = [getattr(kernels, name) for name in KERNELS]
    shard0 = _shard_counts(eng)
    for fn in wrappers:
        fn.launches = fn.calls = 0
    kernels.chunked_matmul.col_launches = 0
    t0 = time.perf_counter()
    done = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in zip(KERNELS, wrappers)}
    launches["chunked_matmul_col"] = kernels.chunked_matmul.col_launches
    sharded, runs = (a - b for a, b in zip(_shard_counts(eng), shard0))
    launches["chunked_matmul_shard"] = runs
    assert all(fn.calls == fn.launches for fn in wrappers), [
        (fn.calls, fn.launches) for fn in wrappers]
    prefills, decodes = sched.stats.prefills, dec.decode_calls
    per_call = 7 * n_layers + 1
    assert len(done) == len(lengths), done
    for req in done:
        assert len(req.generated) == 8, (req.rid, req.generated)
        assert all(0 <= t < VOCAB for t in req.generated)
    assert launches["chunked_matmul"] == per_call * (
        prefills + decodes) + runs - sharded, (launches, prefills, decodes,
                                               sharded, runs)
    assert launches["paged_attention"] == n_layers * decodes, launches
    assert launches["flash_attention"] == n_layers * prefills, launches
    log(f"{tag} served {len(done)} requests in {wall:.2f} s: ticks "
        f"{sched.stats.ticks}, prefills {prefills}, decode "
        f"ticks {decodes}, preemptions {sched.stats.preemptions}")
    log(f"{tag} launches: chunked_matmul {launches['chunked_matmul']} = "
        f"{per_call} x {prefills + decodes} run_pipeline calls"
        + (f" + {runs - sharded} more for {sharded} sharded sites (of them "
           f"{runs} at shard shapes)" if sharded else "")
        + f" (of them {launches['chunked_matmul_col']} in the column "
        f"layouts), paged_attention {launches['paged_attention']} = "
        f"{n_layers} x {decodes} decode ticks, flash_attention "
        f"{launches['flash_attention']} = {n_layers} x {prefills} prefills")
    walls = {}
    for req in sorted(done, key=lambda r: r.rid):
        tpot = (req.done_s - req.first_token_s) / (len(req.generated) - 1)
        walls[req.rid] = (req.first_token_s * 1e3, tpot * 1e3)
        log(f"  {tag} req{req.rid}: prompt {len(req.prompt)} tokens, ttft "
            f"{req.first_token_s * 1e3:.1f} ms, tpot {tpot * 1e3:.1f} ms, "
            f"tokens {req.generated}")
    return launches, dec, kv, walls


def _fixed_session(eng, tokens=None):
    """The fixed prompt's 32-token prefill and 4 decode steps: the logits
    of each call on the host [5, vocab] and the tokens fed (its own argmax,
    or ``tokens``: teacher-forced to another engine's sequence)."""
    prompt = [int(t) for t in np.random.default_rng(
        FIXED_PROMPT_SEED).integers(0, VOCAB, 32)]
    sess = eng.start_session(prompt)
    logits, fed = [sess["logits"]], []
    for i in range(FIXED_STEPS):
        tok = tokens[i] if tokens is not None else int(np.argmax(logits[-1]))
        sess["tok"] = tok
        fed.append(tok)
        eng.session_step(sess)
        logits.append(sess["logits"])
    return np.stack(logits), fed


def phase_serving(n_layers: int):
    from repro_torch.core.llama_graph import init_llama_tensors
    from repro_torch.serving.engine import RelationalEngine
    log(f"== phase 5: serving at Llama-3-8B width, {n_layers} layers, "
        f"on the card")
    if n_layers != N_LAYERS:
        log(f"depth cut: {n_layers} of {N_LAYERS} layers")
    spec = _spec(n_layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_llama_tensors(spec, seed=0, device="cuda")
    n_params = sum(t.numel() for t in params.values())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    # the reference's defaults: row2col="auto", cache_layout="auto"
    eng = RelationalEngine(spec, params, chunk_size=64, max_len=512,
                           device="cuda")
    del params
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    twins = sum(t.cols[c].numel() * t.cols[c].element_size()
                for name, t in eng.env_base.items() if "__col" in name
                for c in t.cols)
    log(f"weights on the card: {n_params / 1e9:.3f} B parameters, "
        f"{4 * n_params / 1e9:.2f} GB f32, drawn in {t1 - t0:.1f} s; "
        f"engine built (decode plan compiled, tables converted, column "
        f"twins built) in {t2 - t1:.1f} s")
    log(f"decode plan: {_plan_summary(eng)}; column twins "
        f"{twins / 1e9:.2f} GB; memory allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    launches, dec, kv, walls = _serve_cold_requests(eng, "[phase 5]")
    log(f"max memory allocated {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB")
    tick = profile_tick(dec)
    del dec, kv
    # the fixed prompt's logits, which phases 7 and 8 are held to
    fixed = _fixed_session(eng)
    log(f"fixed prompt (seed {FIXED_PROMPT_SEED}): prefill T=32 + "
        f"{FIXED_STEPS} decode steps, tokens {fixed[1]}")
    torch.cuda.empty_cache()
    return launches, eng, fixed, tick, walls


def _hold_to_fixed(eng, fixed, tag: str) -> float:
    """The fixed prompt through ``eng``, teacher-forced to phase 5's tokens:
    logits within 1e-3 of phase 5's, greedy tokens equal where phase 5's
    top-2 margin exceeds 1e-3."""
    ref_logits, ref_tokens = fixed
    got, _ = _fixed_session(eng, ref_tokens)
    diff = _assert_logits(got, ref_logits)
    log(f"{tag} fixed prompt, prefill T=32 + {FIXED_STEPS} decode steps fed "
        f"phase 5's tokens: max|Δlogit| against phase 5 {diff:.3e}")
    return diff


def _mem_available() -> int:
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/meminfo has no MemAvailable")


def _pinned_bytes(n_layers: int, budget: int) -> int:
    """Host memory phase 7's cold store pins at ``n_layers``: every row
    table, and column twins of at most ``budget`` bytes (the planner's
    pool), each rounded up to a power of two as PyTorch's pinned allocator
    rounds its blocks (the 2.1 GB lm_head twin: 4.3 GB)."""
    def pow2(n):
        return 1 << (n - 1).bit_length()
    d, dh, ff = D_MODEL, HEAD_DIM, D_FF
    layer = [N_HEADS * dh * d, N_KV * dh * d, N_KV * dh * d, d * d,
             ff * d, d * ff, ff * d, d, d]
    rows = 2 * pow2(4 * VOCAB * d) + pow2(4 * d) + n_layers * sum(
        pow2(4 * n) for n in layer)
    return rows + pow2(4 * VOCAB * d) + budget


def _h2d_rate() -> float:
    """Bytes/s of a plain pinned 1 GiB ``copy_`` host → device: the median
    of 5, timed with CUDA events."""
    src = torch.empty(1 << 30, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    for _ in range(2):
        dst.copy_(src, non_blocking=True)
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dst.copy_(src, non_blocking=True)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del src, dst
    return (1 << 30) / (statistics.median(times) / 1e3)


def phase_paged_serving(fixed):
    """Paged serving at Llama-3-8B width (the paper's Disk+mem mode): the
    planned defaults with ``residency="paged"``, the cold tables in pinned
    host memory, ``pager_policy="pin"`` and a 16 GiB budget against the
    decode step's 32.1 GB of weights; phase 5's request set; the fixed
    prompt held to phase 5's logits."""
    from repro_torch.core.llama_graph import init_llama_tensors
    from repro_torch.serving.engine import RelationalEngine
    log(f"== phase 7: paged serving at Llama-3-8B width: cold tables in "
        f"pinned host memory, pager_policy=pin, budget_bytes "
        f"{PAGED_BUDGET / 2**30:.0f} GiB")
    avail0 = _mem_available()
    rate = _h2d_rate()
    log(f"host MemAvailable before the cold store {avail0 / 1e9:.2f} GB; "
        f"pinned 1 GiB copy_ host to device: {rate / 1e9:.2f} GB/s (median "
        f"of 5)")
    n_layers = N_LAYERS
    while n_layers > 1 and (_pinned_bytes(n_layers, PAGED_BUDGET)
                            + HOST_MARGIN > avail0):
        n_layers -= 1
    need = _pinned_bytes(n_layers, PAGED_BUDGET)
    if n_layers != N_LAYERS:
        log(f"depth cut: {n_layers} of {N_LAYERS} layers, because the "
            f"host's {avail0 / 1e9:.2f} GB available cannot hold the "
            f"{_pinned_bytes(N_LAYERS, PAGED_BUDGET) / 1e9:.2f} GB of pinned "
            f"cold store 32 layers need beside a "
            f"{HOST_MARGIN / 2**30:.0f} GiB margin")
        ref = RelationalEngine(_spec(n_layers), init_llama_tensors(
            _spec(n_layers), seed=0, device="cuda"), chunk_size=64,
            max_len=512, device="cuda")
        fixed = _fixed_session(ref)
        del ref
        gc.collect()
        torch.cuda.empty_cache()
        log(f"fixed prompt's reference logits from an in-memory engine at "
            f"{n_layers} layers")
    spec = _spec(n_layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_llama_tensors(spec, seed=0, device="cuda")
    # each table into a pinned host tensor of its own, one at a time
    for name in list(params):
        host = torch.empty(params[name].shape, dtype=params[name].dtype,
                           pin_memory=True)
        host.copy_(params[name])
        params[name] = host
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    eng = RelationalEngine(spec, params, chunk_size=64, max_len=512,
                           residency="paged", budget_bytes=PAGED_BUDGET,
                           pager_policy="pin", device="cuda")
    del params
    t2 = time.perf_counter()
    pager = eng.pager
    avail1 = _mem_available()
    plan = eng.decode_pipe.layout_plan
    denied = sum(d.denied_by_budget for d in plan.decisions)
    col = sum(d.layout != "row_chunk" for d in plan.decisions)
    pool = eng._residency_pool
    log(f"cold store: {pager.total_cold_bytes() / 1e9:.2f} GB in "
        f"{len(pager._cold)} pinned host tensors (estimated pinned need "
        f"{need / 1e9:.2f} GB); weights drawn and copied to pinned memory in "
        f"{t1 - t0:.1f} s; engine built (plan, column twins converted on the "
        f"card into the cold store) in {t2 - t1:.1f} s; host MemAvailable "
        f"after {avail1 / 1e9:.2f} GB (used {(avail0 - avail1) / 1e9:.2f} "
        f"GB)")
    log(f"decode plan under the budget: {_plan_summary(eng)}; {col} sites in "
        f"the column layouts, {denied} denied by the budget "
        f"(denied_by_budget); the pool committed {pool.spent / 1e9:.2f} GB "
        f"of column copies ({len(pool.tables)} tables); working set of the "
        f"decode plan {_working_set(eng) / 1e9:.2f} GB")
    stats0 = dict(vars(pager.stats))
    launches, dec, kv, _ = _serve_cold_requests(eng, "[phase 7]")
    calls = (launches["flash_attention"]
             + launches["paged_attention"]) // n_layers
    stats = {k: v - stats0[k] if k != "peak_bytes" else v
             for k, v in vars(pager.stats).items()}
    assert pager.stats.peak_bytes <= PAGED_BUDGET, vars(pager.stats)
    assert stats["evictions"] > 0, stats
    log(f"[phase 7] pager over the run: {stats}; "
        f"{stats['bytes_loaded'] / calls / 1e9:.2f} GB loaded a pipeline "
        f"call ({calls} calls); peak held {pager.stats.peak_bytes / 1e9:.2f} "
        f"GB <= budget {PAGED_BUDGET / 1e9:.2f} GB")
    tick = profile_tick(dec, pager)
    per_tick = tick["bytes_a_tick"]
    bound_ms = per_tick / rate * 1e3
    log(f"[phase 7] a decode tick (B=3) streams {per_tick / 1e9:.2f} GB "
        f"(mean over the 5 timed ticks); the pager's "
        f"bound at the measured {rate / 1e9:.2f} GB/s: {bound_ms:.1f} ms; "
        f"median tick wall {tick['wall_ms']:.1f} ms = "
        f"{tick['wall_ms'] / bound_ms:.2f} x the bound")
    log(f"[phase 7] max memory allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, memory reserved "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB (the caching allocator "
        f"keeps freed blocks; the budget bounds what the pager holds)")
    del dec, kv
    diff = _hold_to_fixed(eng, fixed, "[phase 7]")
    summary = {"n_layers": n_layers, "pager": stats,
               "bytes_a_tick": per_tick, "h2d_bytes_per_s": rate,
               "bound_ms": bound_ms, "tick": tick, "max_abs_logit": diff}
    del eng, pager
    gc.collect()
    torch.cuda.empty_cache()
    _release_pinned()
    return launches, summary


def phase_sharded_serving(fixed, tick5, n_shards: int = 2):
    """Sharded serving at Llama-3-8B width, 32 layers, in memory: every
    eligible matmul site split over ``n_shards`` workers on CUDA streams,
    the weight slices views of the resident tables; phase 5's request
    set; the fixed prompt held to phase 5's logits; a batched tick beside
    phase 5's."""
    from repro_torch.core.llama_graph import init_llama_tensors
    from repro_torch.serving.engine import RelationalEngine
    log(f"== phase 8: sharded serving at Llama-3-8B width, {N_LAYERS} "
        f"layers, shards={n_shards}, in memory")
    spec = _spec(N_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = RelationalEngine(spec, init_llama_tensors(spec, seed=0,
                                                    device="cuda"),
                           chunk_size=64, max_len=512, shards=n_shards,
                           device="cuda")
    torch.cuda.synchronize()
    kinds = {}
    for d in eng.decode_pipe.shard_plan.decisions:
        kinds[d.kind] = kinds.get(d.kind, 0) + 1
    log(f"engine built in {time.perf_counter() - t0:.1f} s; decode plan: "
        f"{_plan_summary(eng)}; sharded sites {kinds}; memory allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB (the slices are "
        f"views)")
    launches, dec, kv, _ = _serve_cold_requests(eng, "[phase 8]")
    log(f"[phase 8] max memory allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; pool: "
        f"{eng.shard_pool.stats.sites} sites fanned out, worker busy "
        f"{eng.shard_pool.stats.fanout_s:.2f} s summed, "
        f"{eng.shard_pool.stats.critical_s:.2f} s critical path")
    tick = profile_tick(dec)
    log(f"[phase 8] batched tick (B=3), sharded against phase 5's "
        f"unsharded: host wall {tick['wall_ms']:.2f} against "
        f"{tick5['wall_ms']:.2f} ms, device busy "
        + (f"{tick['busy_ms']:.2f} against {tick5['busy_ms']:.2f} ms"
           if tick["busy_ms"] is not None and tick5["busy_ms"] is not None
           else "not measured"))
    del dec, kv
    diff = _hold_to_fixed(eng, fixed, "[phase 8]")
    eng.shard_pool.shutdown()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches, {"tick": tick, "max_abs_logit": diff}


@contextlib.contextmanager
def _http_server(eng, metrics, tracer, drift_every=0, n_pages=HTTP_POOL):
    """An ``AsyncLLMServer`` over ``eng`` on an ephemeral port, its event
    loop and scheduler in threads of their own (the scheduler makes the
    engine's card current there), over ``n_pages`` KV pages; shut down on
    leaving, whatever happened."""
    from repro_torch.serving.kvcache import PagedKVCache, PagedKVConfig
    from repro_torch.serving.server import AsyncLLMServer, ServerConfig
    spec = eng.spec
    kv = PagedKVCache(PagedKVConfig(
        n_layers=spec.n_layers, n_kv=spec.n_kv, head_dim=spec.head_dim,
        page_size=HTTP_PAGE, n_pages=n_pages,
        max_pages_per_seq=eng.max_len // HTTP_PAGE), max_seqs=8,
        device=eng.device)
    cfg = ServerConfig(port=0, max_batch=3, max_queue_depth=32,
                       flight_capacity=4096, drift_every=drift_every)
    srv = AsyncLLMServer(eng, kv, cfg, metrics=metrics, tracer=tracer)
    srv.start_in_thread()
    try:
        yield srv
    finally:
        srv.shutdown()


def _http_streams(srv, prompts, n_new):
    """Concurrent SSE completions, each stream consumed to its end."""
    from repro_torch.serving import client

    async def drive():
        return await asyncio.wait_for(asyncio.gather(*(
            client.stream_completion(srv.cfg.host, srv.port,
                                     {"prompt": p, "max_tokens": n_new})
            for p in prompts)), HTTP_TIMEOUT_S)
    results = asyncio.run(drive())
    for r in results:
        assert r.status == 200, (r.status, r.error)
        # SSE chunks in order, no gap, no duplicate
        assert r.token_indices == list(range(n_new)), r.token_indices
    return results


def _http_get(srv, path: str):
    from repro_torch.serving import client
    resp = asyncio.run(client.request(srv.cfg.host, srv.port, "GET", path))
    assert resp.status == 200, (path, resp.status, resp.body[:300])
    return resp


def _decode_walls(srv):
    """Host wall (ms) of every decode tick the server's flight ring holds."""
    return [t.wall_us / 1e3 for t in srv.flight.ticks() if t.kind == "decode"]


def _tick_gaps(t, n: int = 4):
    """The ``n`` longest stretches of a flight tick's wall outside its
    top-level spans, in ms, each named by the spans around it."""
    spans = sorted((s for s in t.spans if s.depth == 0),
                   key=lambda s: s.ts_us)
    gaps, end, before = [], t.ts_us, "<tick>"
    for sp in spans:
        gaps.append(((sp.ts_us - end) / 1e3, f"{before} -> {sp.name}"))
        end, before = max(end, sp.ts_us + sp.dur_us), sp.name
    gaps.append(((t.ts_us + t.wall_us - end) / 1e3, f"{before} -> <end>"))
    return [(round(ms, 2), where) for ms, where in sorted(gaps)[::-1][:n]]


def _step_families(srv):
    """Mean ms a decode tick spends in each family of top-level spans
    (pipeline steps by name without their counter or layer suffix, the
    decoder's phases, plan compiles) over the flight ring's decode ticks,
    largest first."""
    ticks = [t for t in srv.flight.ticks() if t.kind == "decode"]
    fam = {}
    for t in ticks:
        for sp in t.spans:
            if sp.depth:
                continue
            name = sp.name.split(":")[0]
            parts = name.split("_")
            while len(parts) > 1 and (parts[-1].isdigit() or (
                    parts[-1][:1] == "L" and parts[-1][1:].isdigit())):
                parts.pop()
            key = f"{sp.cat}:{'_'.join(parts)}"
            fam[key] = fam.get(key, 0.0) + sp.dur_us / 1e3 / len(ticks)
    return sorted(fam.items(), key=lambda kv: -kv[1])


def _stream_walls(results):
    """Each stream's client-side TTFT and TPOT in ms (connect to first
    chunk; the rest over the remaining tokens)."""
    return [(r.ttft_s * 1e3,
             (r.total_s - r.ttft_s) / max(1, len(r.tokens) - 1) * 1e3)
            for r in results]


def _http_traffic(vocab: int):
    """Phase 9's prompts: the eight preempted streams, the shared-prefix
    donor and hits, and phase 5's request set."""
    rng = np.random.default_rng(9)
    streams = [[int(t) for t in rng.integers(0, vocab, 20 + i % 3)]
               for i in range(HTTP_STREAMS)]
    shared = [int(t) for t in rng.integers(0, vocab, HTTP_SHARED)]
    donor = shared + [int(t) for t in rng.integers(0, vocab, 4)]
    hits = [shared + [int(t) for t in rng.integers(0, vocab, n)]
            for n in HTTP_HIT_TAILS]
    rng = np.random.default_rng(2)  # phase 5's draw
    cold5 = [[int(t) for t in rng.integers(0, vocab, n)]
             for n in (32, 64, 32, 64)]
    return streams, donor, hits, cold5


def serve_http(eng):
    """Phase 9's traffic through the HTTP server over ``eng`` (which has a
    tracer and a metrics registry attached): the eight preempted streams,
    then the shared-prefix donor and hits, with the tracer and the drift
    watchdog on; then, with the tracer off, the eight streams again and
    phase 5's request set.  Every check of the phase is here; returns the
    kernels' launches over both servers and a summary."""
    from repro_torch import kernels
    from repro_torch.core.pipeline import step_span_args
    from repro_torch.obs import MetricsRegistry, set_flight_recorder
    tracer, reg = eng.tracer, eng.metrics
    streams, donor, hits, cold5 = _http_traffic(eng.spec.vocab)
    prompts = streams + [donor] + hits
    # the references (the same engine's generate, untraced) and the plans
    # the traffic needs, compiled before the requests arrive; a re-plan of
    # the watchdog recompiles inside ticks, under compile spans
    eng.tracer = None
    t0 = time.perf_counter()
    refs = [eng.generate(p, HTTP_NEW).tokens for p in prompts]

    def compile_plans():
        for n in sorted({len(p) for p in prompts + cold5}):
            eng._prefill_pipe(n)
        for n in HTTP_HIT_TAILS:
            eng._prefill_pipe(n, True)
        for bucket in (1, 2, 4):
            eng._batched_decode_pipe(bucket)
    compile_plans()
    # the step spans' provenance of these plans, which a traced compile
    # derives with the plan
    for pipe in [*eng._prefill_pipes.values(),
                 *eng._batched_pipes.values()]:
        step_span_args(pipe)
    log(f"[phase 9] references ({len(prompts)} x generate, {HTTP_NEW} "
        f"tokens) and plans in {time.perf_counter() - t0:.1f} s")
    eng.tracer = tracer
    tracer.clear()

    wrappers = [getattr(kernels, name) for name in KERNELS]
    for fn in wrappers:
        fn.launches = fn.calls = 0
    kernels.chunked_matmul.col_launches = 0
    # the cyclic collector's pauses on the tracer's timeline: the flight
    # ring retains every tick's spans, and a full collection walks them
    pauses, opened = [], {}

    def on_gc(phase, info):
        if phase == "start":
            opened["t"] = tracer._now_us()
        elif "t" in opened:
            pauses.append((opened.pop("t"), tracer._now_us(),
                           info["generation"]))
    gc.callbacks.append(on_gc)
    t0 = time.perf_counter()
    with _http_server(eng, reg, tracer,
                      drift_every=HTTP_DRIFT_EVERY) as srv:
        got = _http_streams(srv, streams, HTTP_NEW)
        preempted = srv.batcher.stats.preemptions
        traced_walls = _decode_walls(srv)
        families = _step_families(srv)
        got += _http_streams(srv, [donor], HTTP_NEW)
        got += _http_streams(srv, hits, HTTP_NEW)
        scrape = _http_get(srv, "/metrics").body.decode()
        flight = _http_get(srv, "/debug/flight").json()
        trace = _http_get(srv, f"/debug/trace/{got[0].trace_id}").json()
        drift = _http_get(srv, "/debug/drift").json()
        stats = vars(srv.batcher.stats).copy()
        # the least-attributed ticks, with where their time went unnamed
        low_ticks = [(t.kind, t.tick, t.coverage(), t.ts_us, t.wall_us,
                      t.named_us(), _tick_gaps(t)) for t in sorted(
                          (t for t in srv.flight.ticks()
                           if t.kind != "admission"),
                          key=lambda t: t.coverage())[:4]]
        trace = {"ticks": trace["ticks"], "wall_us": trace["wall_us"],
                 "coverage": trace["coverage"],
                 "events": len(trace["traceEvents"]),
                 "cats": {e["cat"] for e in trace["traceEvents"]}}
    gc.callbacks.remove(on_gc)
    traced_s = time.perf_counter() - t0
    # the traced server's flight ring is gone: collect its spans now, so
    # the untraced runs are not charged for them, and recompile what a
    # re-plan of the watchdog dropped
    eng.tracer = None
    gc.collect()
    compile_plans()
    t0 = time.perf_counter()
    with _http_server(eng, MetricsRegistry(), None) as srv:
        plain = _http_streams(srv, streams, HTTP_NEW)
        plain_walls = _decode_walls(srv)
        plain_preempted = srv.batcher.stats.preemptions
    # phase 5's request set, with phase 5's room in the page pool
    with _http_server(eng, MetricsRegistry(), None, n_pages=128) as srv:
        served5 = _http_streams(srv, cold5, 8)
        assert srv.batcher.stats.preemptions == 0
    untraced_s = time.perf_counter() - t0
    set_flight_recorder(None)
    cuda = eng.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in zip(KERNELS, wrappers)}
    launches["chunked_matmul_col"] = kernels.chunked_matmul.col_launches
    if cuda:
        assert all(fn.calls == fn.launches for fn in wrappers), [
            (fn.calls, fn.launches) for fn in wrappers]
    log(f"[phase 9] traced server: {len(got)} streams in {traced_s:.1f} s, "
        f"scheduler {stats}; untraced server: {len(plain) + len(served5)} "
        f"streams in {untraced_s:.1f} s; launches {launches}")

    # the batcher preempted, and every stream's tokens equal generate's
    # where every step's top-2 margin exceeds 1e-3 (phase 5's rule)
    assert preempted > 0 and plain_preempted > 0, (preempted,
                                                   plain_preempted)
    worst = []
    for tag, served in (("traced", got), ("untraced", plain)):
        for i, (p, r) in enumerate(zip(prompts, served)):
            div = _first_divergence(eng, p, refs[i], r.tokens)
            if div is not None:
                assert div[1] <= 1e-3, (tag, i, div)
                worst.append((tag, i, *div))
    log(f"[phase 9] preemptions {preempted} traced, {plain_preempted} "
        f"untraced; tokens against generate: " + (
            "identical" if not worst else
            f"first divergences (run, stream, step, top-2 margin) {worst}, "
            f"each at a margin <= 1e-3, the comparison stopped there"))
    hits_line = [line for line in scrape.splitlines() if line.startswith(
        'serving_prefills_total{kind="prefix_hit"}')]
    assert hits_line and float(hits_line[0].split()[-1]) > 0, scrape
    for line in scrape.splitlines():
        if line.startswith(("serving_prefills_total",
                            "drift_watchdog_", "engine_replans_total")):
            log(f"  [phase 9] scrape: {line}")
    # the flight recorder attributes every tick (the reference's bar)
    ticks = flight["ticks"]
    low = [(t["kind"], t["tick"], round(t["coverage"], 4)) for t in ticks
           if t["coverage"] < 0.9]
    by_kind = {}
    for t in ticks:
        by_kind.setdefault(t["kind"], []).append(t["coverage"])
    coverage = {k: {"ticks": len(v), "min": min(v),
                    "median": statistics.median(v)}
                for k, v in by_kind.items()}
    log(f"[phase 9] /debug/flight: {flight['retained_ticks']} ticks "
        f"retained, coverage by kind {coverage}")
    full = [(a, b) for a, b, gen in pauses if gen == 2]
    log(f"[phase 9] cyclic GC during the traced run: {len(pauses)} "
        f"collections, {len(full)} full, full pauses "
        f"{sorted(round((b - a) / 1e3, 1) for a, b in full)} ms")
    for kind, tick, cov, ts, wall, named, gaps in low_ticks:
        in_gc = sum(max(0.0, min(b, ts + wall) - max(a, ts))
                    for a, b, _ in pauses)
        log(f"  [phase 9] {kind} tick {tick}: coverage {cov:.4f}, wall "
            f"{wall / 1e3:.1f} ms, unattributed {(wall - named) / 1e3:.1f} "
            f"ms, of it inside GC pauses at most {in_gc / 1e3:.1f} ms; "
            f"longest unnamed stretches (ms) {gaps}")
    assert not low, low
    # one request rebuilt end to end from the flight ring
    kinds, cats = [t["kind"] for t in trace["ticks"]], trace["cats"]
    assert kinds[0] == "admission" and "prefill" in kinds \
        and "decode" in kinds, kinds
    assert {"step", "op"} <= cats, cats
    log(f"[phase 9] /debug/trace/{got[0].trace_id}: ticks {kinds}, "
        f"{trace['events']} events, categories {sorted(cats)}, "
        f"wall {trace['wall_us'] / 1e3:.1f} ms, coverage "
        f"{trace['coverage']:.4f}")
    assert drift.get("every") == HTTP_DRIFT_EVERY and drift["ticks"] > 0, \
        drift
    log(f"[phase 9] /debug/drift: ticks {drift['ticks']}, checks "
        f"{drift['checks']}, replans {drift['replans']} (engine "
        f"{drift['engine_replans']}), errors {drift['errors']}, last rms "
        f"relative drift " + (f"{drift['last_report']['rms_rel_drift']:.3f}"
                              if drift["last_report"] else "none"))
    assert drift["errors"] == 0, drift
    # the tracer's cost: the same traffic's decode ticks with and without
    traced_ms = statistics.median(traced_walls)
    plain_ms = statistics.median(plain_walls)
    log(f"[phase 9] decode tick of the eight streams: traced median "
        f"{traced_ms:.2f} ms over {len(traced_walls)} ticks, untraced "
        f"{plain_ms:.2f} ms over {len(plain_walls)} ticks "
        f"({traced_ms / plain_ms:.2f}x)")
    log("[phase 9] where a traced decode tick's time goes (mean ms a "
        "tick, top-level spans by family; steps end in a synchronise):")
    for key, ms in families[:14]:
        log(f"  {ms:9.3f} ms  {key}")
    walls9 = _stream_walls(served5)
    for i, (ttft, tpot) in enumerate(walls9):
        log(f"  [phase 9] phase 5's req{i} through HTTP, untraced: ttft "
            f"{ttft:.1f} ms, tpot {tpot:.1f} ms")
    return launches, {
        "decode_tick_traced_ms": traced_ms,
        "decode_tick_untraced_ms": plain_ms,
        "ticks_traced": len(traced_walls), "ticks_untraced": len(plain_walls),
        "coverage": coverage, "preemptions": preempted,
        "gc_full_pauses_ms": sorted((b - a) / 1e3 for a, b in full),
        "traced_tick_families_ms": dict(families[:14]),
        "prefix_hits": float(hits_line[0].split()[-1]),
        "watchdog": {k: drift[k] for k in ("ticks", "checks", "replans")},
        "http_ttft_tpot_ms": walls9,
        "streams_traced_ttft_tpot_ms": _stream_walls(got[:HTTP_STREAMS]),
        "streams_untraced_ttft_tpot_ms": _stream_walls(plain),
        "token_divergences": worst}


def phase_http_serving(fixed, walls5):
    """HTTP serving at Llama-3-8B width and depth under the reference's
    defaults, in memory, with a ``TraceRecorder`` and a
    ``MetricsRegistry`` attached and the drift watchdog armed: the fixed
    prompt held to phase 5's logits with the tracer on, then
    :func:`serve_http`; phase 5's request set through HTTP beside phase 5's
    TTFT and TPOT."""
    from repro_torch.core.llama_graph import init_llama_tensors
    from repro_torch.obs import MetricsRegistry, TraceRecorder
    from repro_torch.serving.engine import RelationalEngine
    log(f"== phase 9: HTTP serving at Llama-3-8B width, {N_LAYERS} layers, "
        f"traced, the drift watchdog every {HTTP_DRIFT_EVERY} ticks")
    spec = _spec(N_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = RelationalEngine(spec, init_llama_tensors(spec, seed=0,
                                                    device="cuda"),
                           chunk_size=64, max_len=512,
                           metrics=MetricsRegistry(), tracer=TraceRecorder(),
                           device="cuda")
    torch.cuda.synchronize()
    log(f"engine built in {time.perf_counter() - t0:.1f} s; decode plan: "
        f"{_plan_summary(eng)}; memory allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    diff = _hold_to_fixed(eng, fixed, "[phase 9, traced]")
    launches, summary = serve_http(eng)
    for rid, (ttft, tpot) in walls5.items():
        log(f"  [phase 9] req{rid}: phase 5 (ContinuousBatcher, no HTTP) "
            f"ttft {ttft:.1f} ms, tpot {tpot:.1f} ms; through HTTP ttft "
            f"{summary['http_ttft_tpot_ms'][rid][0]:.1f} ms, tpot "
            f"{summary['http_ttft_tpot_ms'][rid][1]:.1f} ms")
    log(f"[phase 9] max memory allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    summary["max_abs_logit_traced"] = diff
    return launches, summary


def _compile_logged(eng, label, compile_fn, *args):
    """Compile one plan through the engine's cache and print its compile
    time and decisions."""
    t0 = time.perf_counter()
    pipe = compile_fn(*args)
    secs = time.perf_counter() - t0
    plan = pipe.layout_plan
    log(f"  plan {label}: compiled in {secs:.2f} s; "
        + ("unplanned" if plan is None else
           f"{len(plan.decisions)} matmul sites, {len(plan.col_decisions)} "
           f"in the column layouts, caches "
           f"{sorted({d.layout for d in plan.cache_decisions})}"))
    return pipe


def _prefix_traffic():
    """Phase 6's prompts: the donor, then the five hits."""
    rng = np.random.default_rng(6)
    shared = [int(t) for t in rng.integers(0, VOCAB, SHARED_PREFIX)]
    donor = shared + [int(t) for t in rng.integers(0, VOCAB, DONOR_TAIL)]
    return [donor] + [shared + [int(t) for t in rng.integers(0, VOCAB, n)]
                      for n in HIT_TAILS]


def _serve_prefix_traffic(eng, dec, prompts, metrics=None):
    """The donor alone, then the five requests, through
    ``ContinuousBatcher(max_batch=3)`` with ``prefill_ex``; returns the
    requests by id, the scheduler and each request's prefill wall time
    (host clock, ending in the logits' copy to the host)."""
    from repro_torch.serving.kvcache import PagedKVCache, PagedKVConfig
    from repro_torch.serving.scheduler import ContinuousBatcher, Request
    kv = PagedKVCache(PagedKVConfig(n_layers=eng.spec.n_layers, n_kv=N_KV,
                                    head_dim=HEAD_DIM, page_size=16,
                                    n_pages=128, max_pages_per_seq=32),
                      max_seqs=3, device="cuda")
    walls = {}

    def prefill(req, seq_id):
        kv.ensure_capacity(seq_id, len(req.context))
        t0 = time.perf_counter()
        res = dec.prefill_ex(req.context, seq_id)
        walls[req.rid] = time.perf_counter() - t0
        return res

    sched = ContinuousBatcher(kv, prefill, dec.decode, max_batch=3,
                              release_fn=dec.free, metrics=metrics)
    sched.submit(Request(rid=0, prompt=prompts[0],
                         max_new_tokens=NEW_TOKENS))
    sched.run()
    for rid, p in enumerate(prompts[1:], start=1):
        sched.submit(Request(rid=rid, prompt=p, max_new_tokens=NEW_TOKENS))
    done = sched.run()
    torch.cuda.synchronize()
    assert sorted(r.rid for r in done) == list(range(len(prompts))), done
    assert all(len(r.generated) == NEW_TOKENS for r in done)
    return {r.rid: r for r in done}, sched, walls


def _first_divergence(eng, prompt, cold, other):
    """(step, the cold engine's top-2 logit margin there) where two token
    streams first differ, recomputed with start_session/session_step fed
    the cold tokens; None where they agree."""
    i = next((j for j, (a, b) in enumerate(zip(cold, other)) if a != b),
             None)
    if i is None:
        return None
    sess = eng.start_session(prompt)
    for j in range(1, i + 1):
        sess["tok"] = cold[j - 1]
        eng.session_step(sess)
    top2 = np.sort(sess["logits"])[-2:]
    return i, float(top2[1] - top2[0])


def phase_prefix_serving(eng):
    """Prefix-cached serving at Llama-3-8B width on phase 5's engine: the
    reference's default decoder (``prefix_block=16``) under chatbot
    traffic with a long shared system prompt, once per bind mode, with a
    metrics registry attached; the tokens held against a cold decoder's."""
    from repro_torch import kernels
    from repro_torch.obs import MetricsRegistry
    n_layers = eng.spec.n_layers
    log(f"== phase 6: prefix-cached serving at Llama-3-8B width, {n_layers} "
        f"layers: a {SHARED_PREFIX}-token shared prefix, a donor + "
        f"{len(HIT_TAILS)} hits (tails {list(HIT_TAILS)}), {NEW_TOKENS} new "
        f"tokens each")
    prompts = _prefix_traffic()
    t0 = time.perf_counter()
    for p in prompts:
        _compile_logged(eng, f"prefill T={len(p)}", eng._prefill_pipe,
                        len(p))
    for n in HIT_TAILS:
        _compile_logged(eng, f"suffix prefill T={n}", eng._prefill_pipe, n,
                        True)
    log(f"plans compiled (cold T={sorted({len(p) for p in prompts})}, "
        f"suffix T={list(HIT_TAILS)}) in {time.perf_counter() - t0:.2f} s")
    cold_dec = eng.batched_decoder(max_seqs=3, prefix_block=0)
    cold, _, cold_walls = _serve_prefix_traffic(eng, cold_dec, prompts)
    del cold_dec
    wrappers = [getattr(kernels, name) for name in KERNELS]
    per_call = 7 * n_layers + 1
    launches, served, ttft = {}, {}, {}
    for mode in ("copy", "share"):
        # the registry reaches the engine, the decoder, its prefix cache
        # and the scheduler
        reg = eng.metrics = MetricsRegistry()
        dec = eng.batched_decoder(max_seqs=3, prefix_block=16,
                                  prefix_bind=mode)
        for fn in wrappers:
            fn.launches = fn.calls = 0
        kernels.chunked_matmul.col_launches = 0
        done, sched, walls = _serve_prefix_traffic(eng, dec, prompts, reg)
        run = {name: fn.launches for name, fn in zip(KERNELS, wrappers)}
        run["chunked_matmul_col"] = kernels.chunked_matmul.col_launches
        assert all(fn.calls == fn.launches for fn in wrappers), [
            (fn.calls, fn.launches) for fn in wrappers]
        pc = dec.prefix_cache
        cached = [done[r].cached_tokens for r in range(1, len(prompts))]
        assert cached == [SHARED_PREFIX] * len(HIT_TAILS), cached
        assert pc.stats.hits == len(HIT_TAILS), vars(pc.stats)
        hits = reg.counter("serving_prefills_total", kind="prefix_hit").value
        assert hits == len(HIT_TAILS), reg.render_prometheus()
        prefills = sched.stats.prefills
        suffix_k3 = sum(n > 1 for n in HIT_TAILS)
        suffix_k2 = len(HIT_TAILS) - suffix_k3
        cold_prefills = prefills - len(HIT_TAILS)
        assert run["chunked_matmul"] == per_call * (
            prefills + dec.decode_calls), (run, prefills, dec.decode_calls)
        assert run["flash_attention"] == n_layers * (
            cold_prefills + suffix_k3), run
        assert run["paged_attention"] == n_layers * (
            dec.decode_calls + suffix_k2), run
        launches[mode] = run
        served[mode] = {r: req.generated for r, req in done.items()}
        ttft[mode] = {r: (req.first_token_s, walls[r])
                      for r, req in done.items()}
        log(f"[{mode}] prefills {prefills} (cold {sched.stats.prefills_cold},"
            f" prefix hits {sched.stats.prefills_prefix_hit}), decode ticks "
            f"{dec.decode_calls}; launches: chunked_matmul "
            f"{run['chunked_matmul']} = {per_call} x "
            f"{prefills + dec.decode_calls} run_pipeline calls, "
            f"flash_attention {run['flash_attention']} = {n_layers} x "
            f"({cold_prefills} cold + {suffix_k3} suffix prefills of T > 1), "
            f"paged_attention {run['paged_attention']} = {n_layers} x "
            f"({dec.decode_calls} decode ticks + {suffix_k2} one-token "
            f"suffix)")
        for r in sorted(done):
            kind = "donor" if r == 0 else (
                f"hit, tail {len(prompts[r]) - SHARED_PREFIX}")
            log(f"  [{mode}] req{r} ({kind}, {len(prompts[r])} tokens, "
                f"cached {done[r].cached_tokens}): ttft "
                f"{done[r].first_token_s * 1e3:.1f} ms, prefill "
                f"{walls[r] * 1e3:.1f} ms (cold decoder "
                f"{cold_walls[r] * 1e3:.1f} ms), tokens {done[r].generated}")
        log(f"  [{mode}] prefix cache: {len(pc._segments)} segments, "
            f"resident_bytes {pc.resident_bytes} "
            f"({pc.resident_bytes / 1e9:.3f} GB), stats {vars(pc.stats)}")
        for line in reg.render_prometheus().splitlines():
            if line.startswith(("serving_prefills_total",
                                "serving_prefix_cache_")):
                log(f"  [{mode}] scrape: {line}")
        eng.metrics = None
        del dec, pc
        torch.cuda.empty_cache()
    assert served["copy"] == served["share"], served
    worst = []
    for r, p in enumerate(prompts):
        div = _first_divergence(eng, p, cold[r].generated, served["copy"][r])
        if div is not None:
            assert div[1] <= 1e-3, (r, div)
            worst.append((r, *div))
    log("tokens: copy == share; against the prefix_block=0 decoder " + (
        "identical" if not worst else
        f"first divergences (req, step, cold top-2 margin) {worst}, each "
        f"at a margin <= 1e-3"))
    log(f"max memory allocated since phase 5's engine build "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return launches, ttft


def profile_tick(dec, pager=None) -> dict:
    """Where one batched decode tick (3 sequences) spends device time:
    kernels by name from ``torch.profiler``, and the device's idle share of
    the tick's host wall time.  Returns the median unprofiled wall, the
    device busy time (None where the profiler saw no device time) and,
    given the engine's pager, the bytes it loaded a tick."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(3)
    last = [dec.prefill([int(t) for t in rng.integers(0, VOCAB, 32)], s)
            for s in range(3)]
    for _ in range(2):  # warm: view cache and allocator
        last = dec.decode([0, 1, 2], last)
    walls = []
    loaded = pager.stats.bytes_loaded if pager is not None else 0
    for _ in range(5):  # decode returns after the logits' copy to the host
        t0 = time.perf_counter()
        last = dec.decode([0, 1, 2], last)
        walls.append((time.perf_counter() - t0) * 1e3)
    out = {"wall_ms": statistics.median(walls), "walls_ms": walls,
           "busy_ms": None}
    if pager is not None:
        out["bytes_a_tick"] = (pager.stats.bytes_loaded - loaded) / len(walls)
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
        return out
    out["busy_ms"] = busy / 1e3
    out["idle_share"] = 1 - busy / wall_us
    log(f"one decode tick (B=3, bucket 4) under the profiler: wall "
        f"{wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms, idle share "
        f"{1 - busy / wall_us:.3f}; against the unprofiled median wall "
        f"{1 - busy / 1e3 / statistics.median(walls):.3f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"  {us / 1e3:9.3f} ms  {us / busy:6.1%}  {name[:90]}")
    return out


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
    col_steps, col_err = timed("phase 3 (K1 column layouts)",
                               phase_col_kernels, flush)
    cache_rows = timed("phase 3 (K2, K3 cache orders)",
                       phase_cache_layout_attention, flush)
    quant_k1 = timed("phase 3 (quantised K1)", phase_quant_k1, flush)
    shard_steps, shard_err = timed("phase 3 (K1 shard slices)",
                                   phase_shard_kernels, flush)
    del flush
    _, phase4_shard_launches = timed("phase 4", phase_engine_parity)
    serving, eng, fixed, tick5, walls5 = timed("phase 5", phase_serving,
                                               N_LAYERS)
    prefix, _ = timed("phase 6", phase_prefix_serving, eng)
    cache_layout = eng.cache_layout
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    paged, paged_summary = timed("phase 7", phase_paged_serving, fixed)
    sharded, _ = timed("phase 8", phase_sharded_serving, fixed, tick5)
    http, http_summary = timed("phase 9", phase_http_serving, fixed, walls5)
    # each main path's counts, zeroed just before it and read just after:
    # phase 5's cold serving, phase 6's prefix-cached serving per bind mode,
    # phase 7's paged serving, phase 8's sharded serving and phase 9's HTTP
    # serving (traced and untraced)
    paths = {"serving": serving, "prefix_serving_copy": prefix["copy"],
             "prefix_serving_share": prefix["share"],
             "paged_serving": paged, "sharded_serving": sharded,
             "http_serving": http}
    counted = KERNELS + ("chunked_matmul_col",)
    launches = {name: sum(p[name] for p in paths.values())
                for name in counted}
    by_path = {name: {path: p[name] for path, p in paths.items()}
               for name in counted}
    assert launches["chunked_matmul_col"] > 0, launches
    assert all(p[name] > 0 for p in paths.values() for name in KERNELS), \
        paths
    assert sharded["chunked_matmul_shard"] > 0, sharded
    log("kernels: K1 chunked_matmul: ok, K2 paged_attention: ok, "
        "K3 flash_attention: ok")
    log(f"total wall {time.perf_counter() - t_all:.1f} s")
    kernels = [{
        "name": "chunked_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/chunked_matmul.cu",
        "replaces": REPLACES["chunked_matmul"],
        "launches": launches["chunked_matmul"],
        "launches_by_path": by_path["chunked_matmul"], "max_abs_err": max_err,
        "ms": step["kernel_ms"], "plain_ms": step["plain_ms"],
        "bound_ms": step["bound_ms"], "bound_by": step["bound_by"],
        "library_ms": step["library_ms"],
        "prefill_ms": prefill["kernel_ms"],
        "prefill_library_ms": prefill["library_ms"],
        "prefill_bound_ms": prefill["bound_ms"],
        "quantised_w1_m1": quant_k1,
        "times_are": f"one decode step's {sum(STEP_COUNTS.values())} GEMMs "
                     f"at M=1 (prefill_*: one {PREFILL_M}-token prefill's), "
                     f"summed from per-shape medians"}]
    for name, what in (("paged_attention", "one decode tick"),
                       ("flash_attention", "one prefill")):
        r = attn_step[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "launches_by_path": by_path[name],
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
    r = attn_step["suffix"]
    kernels[-1]["suffix_prefill"] = {
        "shape": r["shape"], "plan": r["plan"],
        "ms": N_LAYERS * r["kernel_ms"], "plain_ms": N_LAYERS * r["plain_ms"],
        "library_ms": N_LAYERS * r["library_ms"],
        "bound_ms": N_LAYERS * r["bound_ms"], "bound_by": r["bound_by"],
        "times_are": f"one suffix prefill's {N_LAYERS} launches, q_offset "
                     f"{SUFFIX_STEP[1]}; library: SDPA with the boolean "
                     f"offset mask"}
    # the planned main path: K1 in the column layouts, and K2/K3 over the
    # resolved cache layout (every K2 and K3 launch of phases 5 and 6 read
    # caches in it); the other layout's times ride along in the row
    col = col_steps[1]
    kernels.append({
        "name": "chunked_matmul (column layouts)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/chunked_matmul.cu",
        "replaces": REPLACES["chunked_matmul"],
        "launches": launches["chunked_matmul_col"],
        "launches_by_path": by_path["chunked_matmul_col"],
        "max_abs_err": col_err, "ms": col["kernel_ms"],
        "plain_ms": col["plain_ms"], "bound_ms": col["bound_ms"],
        "bound_by": col["bound_by"], "library_ms": col["library_ms"],
        "decode_m4_ms": col_steps[4]["kernel_ms"],
        "decode_m4_library_ms": col_steps[4]["library_ms"],
        "prefill_ms": col_steps[PREFILL_M]["kernel_ms"],
        "prefill_library_ms": col_steps[PREFILL_M]["library_ms"],
        "prefill_bound_ms": col_steps[PREFILL_M]["bound_ms"],
        "times_are": f"one decode step's {sum(COL_COUNTS.values())} "
                     f"column-layout GEMMs (Q COLH, o, W1, W3 a layer, "
                     f"lm_head) at M=1 (decode_m4_*: M=4, prefill_*: "
                     f"M={PREFILL_M}); library: torch.matmul"})
    if cache_layout != "row_chunk":
        others = [lay for lay in ("head_major", "pos_major")
                  if lay != cache_layout]
        for name in ("paged_attention", "flash_attention"):
            r = cache_rows[(name, cache_layout)]

            def scaled(row):
                return {k: (N_LAYERS * v if k.endswith("_ms") else v)
                        for k, v in row.items() if k != "max_abs_err"}
            kernels.append({
                "name": f"{name} ({cache_layout})", "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                "replaces": REPLACES[name],
                "launches": launches[name],
                "launches_by_path": by_path[name],
                "max_abs_err": r["max_abs_err"],
                "ms": N_LAYERS * r["kernel_ms"],
                "plain_ms": N_LAYERS * r["plain_ms"],
                "bound_ms": N_LAYERS * r["bound_ms"],
                "bound_by": r["bound_by"],
                "library_ms": N_LAYERS * r["library_ms"],
                **{lay: scaled(cache_rows[(name, lay)]) for lay in others},
                "times_are": f"{N_LAYERS} launches at {r['shape']} over "
                             f"{cache_layout} caches, {N_LAYERS} x the "
                             f"per-launch median"})
    # K1 at one shard's slices: N = 2 ran on phase 8's main path, N = 4 in
    # phase 4's depth-2 cases (shards=4 in memory and paged)
    shard_paths = {2: {"sharded_serving": sharded["chunked_matmul_shard"]},
                   4: {"phase4_shards_4": phase4_shard_launches[4]}}
    for n in SHARD_NS:
        r, pre = shard_steps[(n, 1)], shard_steps[(n, PREFILL_M)]
        kernels.append({
            "name": f"chunked_matmul (shard slices, N={n})", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/chunked_matmul.cu",
            "replaces": REPLACES["chunked_matmul"],
            "launches": sum(shard_paths[n].values()),
            "launches_by_path": shard_paths[n],
            "max_abs_err": shard_err, "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "contiguous_ms": r["contiguous_ms"],
            "prefill_ms": pre["kernel_ms"],
            "prefill_library_ms": pre["library_ms"],
            "prefill_bound_ms": pre["bound_ms"],
            "prefill_contiguous_ms": pre["contiguous_ms"],
            "times_are": f"one decode step's 225 sharded GEMMs at M=1, "
                         f"{n} launches a site on the strided slices the "
                         f"workers pass (contiguous_ms: on contiguous copies "
                         f"of the slices; prefill_*: M={PREFILL_M}), "
                         f"summed from shard 0's per-shape medians; library: "
                         f"torch.matmul on the same views"})
    log(f"phase 7 (paged): {json.dumps(paged_summary)}")
    log(f"phase 9 (HTTP): {json.dumps(http_summary)}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
