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
untraced for the tracer's cost).  Phase 10 runs the paper's dense baseline,
``DirectEngine`` over the model stack, on phase 5's weights carried through
the bridge: phase 5's requests and fixed prompt in memory (a decode step
profiled), one request paged from pinned host memory through phase 7's
budget, and every model family (the TINY configs, OLMoE-1B-7B and
Mamba2-2.7B at their published widths cut to 2 layers) on the card against
the CPU; it launches none of K1-K3.  Phase 11 trains: Llama-3.2-3B at full
width and depth (bf16, remat, AdamW) through ``make_train_step`` for a
warm-up and 8 timed steps (one profiled, the clip and the update timed
apart), its width at depth 2 in f32 against the CPU (loss, gradients,
remat, one step), and the recovery driver at depth 2 restarting from a
checkpoint to the uninterrupted run's loss; it launches none of K1-K3
either.  Phase 12 runs the distributed path at world size 1 over NCCL:
phase 11's steps on DTensor leaves placed by ``param_pspecs`` on a (1, 1)
mesh (the first loss equal to phase 11's), the int8 error-feedback
all-reduce, the hierarchical psum, a one-stage pipeline against the dense
loop, and the elastic reshard of the params onto a (1, 1, 1) mesh; it
launches none of K1-K3.  Phase 13 runs the dry-run (``python -m
repro_torch.launch.dryrun`` and the hillclimb's B1 cell as subprocesses,
on fake 256- and 512-rank meshes) and prints its roofline table, then
counts olmo-1b's decode_32k and train_4k steps at full width and depth on
the card with the dry-run's counters and fails if either runs faster than
the H100 roofline of its own count; it launches none of K1-K3.  Phase 3
times every kernel row twice: with CUDA events around each launch and
again with the launch queued behind a device spin (``sleep_ms``).  Each
serving run checks that every GEMM
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
import os
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

# Llama-3-8B's widths and depth, from the port's model registry (this
# import fails outside a checkout)
from repro_torch.configs.llama3_8b import CONFIG as LLAMA3_8B  # noqa: E402
# the card's data-sheet rates, one source with the dry-run's roofline
from repro_torch.analysis.roofline import HBM_BW, PEAK_FLOPS  # noqa: E402

VOCAB, D_MODEL, N_HEADS, N_KV, D_FF, THETA = (
    LLAMA3_8B.vocab, LLAMA3_8B.d_model, LLAMA3_8B.n_heads, LLAMA3_8B.n_kv,
    LLAMA3_8B.d_ff, LLAMA3_8B.rope_theta)
N_LAYERS = LLAMA3_8B.n_layers

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): memory bytes/s
# and non-tensor-core float32 FLOP/s.  The bound of a kernel is the larger
# of bytes / memory rate and flops / the rate of the units it computes on:
# the f32 rate for K1 and K2; for K3, which multiplies on the tensor cores,
# dense TF32 over 3 in f32 (3xTF32: three products an element) and dense
# bf16 in bf16 (its f32-FMA bound is reported beside).
PEAKS = (HBM_BW, 67e12)
TENSOR_PEAKS = {torch.float32: 495e12 / 3, torch.bfloat16: PEAK_FLOPS}

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
# phase 11: the trainer.  Llama-3.2-3B (the paper's smaller case-study
# model) at full width and depth with its config's defaults (bf16,
# remat="full", ce_impl="gather") and AdamW's, on SyntheticLM batches of
# 4 x 256 tokens: one warm-up step, then 8 timed.  Then its width at depth
# 2: in f32 against the CPU (B = 1, T = 64), and the recovery driver (4
# steps, a crash at step 3, checkpoints every 2 steps into build/)
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 256, 4, 8
PARITY_T, PARITY_LR = 64, 1e-3
RECOVERY_STEPS, RECOVERY_FAIL_AT, RECOVERY_EVERY = 4, 3, 2
TRAIN_CKPT_DIR = ROOT / "build" / "train_ckpt"
# phase 12: the distributed path at world size 1 (one card; NCCL refuses
# two ranks on one GPU): phase 11's model, seed and batches on a (1, 1)
# ("data", "model") mesh under single_pod_rules(fsdp=True), 3 warm-up and
# 5 timed steps; the collectives (an int8 error-feedback all-reduce of a
# [4096, 4096] f32 gradient, the hierarchical psum, a one-stage pipeline
# of 8 [1024, 1024] blocks over 64 rows); the elastic reshard of the
# params onto a (1, 1, 1) ("pod", "data", "model") mesh.  The rendezvous
# is a FileStore under build/.
DIST_WARMUP, DIST_STEPS = 3, 5
DIST_STORE = ROOT / "build" / "dist_store"
DIST_CKPT_DIR = ROOT / "build" / "dist_ckpt"
EF_SHAPE, EF_STD = (4096, 4096), 0.05
PIPE_L, PIPE_D, PIPE_B, PIPE_MICRO = 8, 1024, 64, 4
# phase 13: the dry-run and the roofline.  (a) the dry-run's cells on the
# production meshes, each a subprocess (phase 12 brought up this process's
# default group; the dry-run brings up its own "fake" group of 256 or 512
# ranks): olmo-1b decode on 16x16 and 2x16x16, OLMoE-1B-7B prefill on 16x16
# (expert parallelism), a full-attention long_500k cell (recorded as
# skipped) and the hillclimb's B1_ep_local.  (b) olmo-1b's decode_32k and
# train_4k cells at full width and depth on this card at world size 1, the
# step counted by the dry-run's counters and timed against the H100
# roofline; global_batch cut to fit: decode_32k's 128 sequences of 32768
# cached rows would need 550 GB of K/V (8 x 32768 x 16 layers x 8192 B =
# 34.4 GB at 8); train_4k from 256 to the first of these that fits
DRYRUN_CELLS = [["--arch", "olmo-1b", "--shape", "decode_32k",
                 "--multi-pod", "both"],
                ["--arch", "olmoe-1b-7b", "--shape", "prefill_32k",
                 "--multi-pod", "single"],
                ["--arch", "olmo-1b", "--shape", "long_500k",
                 "--multi-pod", "single"]]
DRYRUN_HILLCLIMB = "B1_ep_local"
DRYRUN_DIR = ROOT / "build" / "dryrun"
DRYRUN_TIMEOUT_S = 300
ROOFLINE_DECODE_BATCH, ROOFLINE_TRAIN_BATCHES = 8, (8, 4, 2, 1)
ROOFLINE_WARMUP, ROOFLINE_STEPS = 2, 5


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


def sleep_ms(fn, flush: torch.Tensor, reps: int = 20, warmup: int = 3,
             spin_cycles: int = 2_000_000):
    """Median device time of ``fn`` as :func:`time_ms` takes it, but with
    each launch queued behind a device spin (``torch.cuda._sleep``, about
    1 ms) after the L2 flush: the host enqueues the start event, ``fn``'s
    launches and the end event while the card spins, so the wrapper's
    Python does not leak into a short kernel's time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(spin_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timings(flush: torch.Tensor, **fns) -> dict:
    """``{name}_ms`` by :func:`time_ms` and ``{name}_sleep_ms`` by
    :func:`sleep_ms` for each ``name=fn``."""
    out = {}
    for name, fn in fns.items():
        out[f"{name}_ms"] = time_ms(fn, flush)
        out[f"{name}_sleep_ms"] = sleep_ms(fn, flush)
    return out


def _sleep_timer(row: dict, scale: float = 1.0) -> dict:
    """A kernels-line row's readings under the sleep timer."""
    return {k.replace("_sleep_ms", "_ms").replace("kernel_ms", "ms"):
            scale * v for k, v in row.items() if k.endswith("_sleep_ms")}


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
                **timings(flush, kernel=lambda: chunked_matmul(x, w),
                          plain=lambda: ref.chunked_matmul(x, w),
                          library=lambda: torch.matmul(x, w.T)),
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
                            "bound_ms", "kernel_sleep_ms", "plain_sleep_ms",
                            "library_sleep_ms")}
        step["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes"
                                           for r in rows if r["M"] == m)
                            else "operations")
        steps[m] = step
        log(f"one {what}'s {sum(STEP_COUNTS.values())} GEMMs at M={m}: "
            f"kernel {step['kernel_ms']:.3f} ms, plain "
            f"{step['plain_ms']:.3f} ms, library {step['library_ms']:.3f} ms,"
            f" bound {step['bound_ms']:.3f} ms ({step['bound_by']}); kernel "
            f"/ library {step['kernel_ms'] / step['library_ms']:.3f}, bound "
            f"/ kernel {step['bound_ms'] / step['kernel_ms']:.3f}; sleep "
            f"timer: kernel {step['kernel_sleep_ms']:.3f} ms, library "
            f"{step['library_sleep_ms']:.3f} ms")
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
             **timings(flush, kernel=kernel, plain=plain, library=library),
             "bound_ms": bound, "bound_by": by, "max_abs_err": e,
             "library_err": (lib.float() - want.float()).abs().max().item()}
        extra = ""
        if rate != PEAKS[1]:
            r["bound_f32_fma_ms"] = _bound(nbytes, flops)[0]
            extra = f" (f32 FMA {r['bound_f32_fma_ms'] * 1e3:.3f} us)"
        rows.append(r)
        log(f"  {name} {shape:24s} kernel {r['kernel_ms']:.4f} ms (sleep "
            f"timer {r['kernel_sleep_ms']:.4f})  plain "
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
            f"{N_LAYERS * r['bound_ms']:.3f} ms; sleep timer: kernel "
            f"{N_LAYERS * r['kernel_sleep_ms']:.3f} ms, library "
            f"{N_LAYERS * r['library_sleep_ms']:.3f} ms")
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
                **timings(flush,
                          kernel=lambda: chunked_matmul(x, w, layout="col"),
                          plain=lambda: ref.chunked_matmul(x, w, "col"),
                          library=lambda: torch.matmul(x, w)),
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
                            "bound_ms", "kernel_sleep_ms", "plain_sleep_ms",
                            "library_sleep_ms")}
        step["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes"
                                           for r in rows if r["M"] == m)
                            else "operations")
        steps[m] = step
        log(f"one {what}'s {sum(COL_COUNTS.values())} column-layout GEMMs "
            f"at M={m}: kernel {step['kernel_ms']:.3f} ms, plain "
            f"{step['plain_ms']:.3f} ms, library {step['library_ms']:.3f} ms,"
            f" bound {step['bound_ms']:.3f} ms ({step['bound_by']}); sleep "
            f"timer: kernel {step['kernel_sleep_ms']:.3f} ms, library "
            f"{step['library_sleep_ms']:.3f} ms")
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
                    **timings(
                        flush,
                        kernel=lambda: chunked_matmul(xs, ws, **kw),
                        contiguous=lambda: chunked_matmul(xs, wc, **kw),
                        plain=lambda: ref.chunked_matmul(
                            xs, ws, "row" if layout == "row" else "col"),
                        library=lib),
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
                                "library_ms", "bound_ms", "kernel_sleep_ms",
                                "contiguous_sleep_ms", "plain_sleep_ms",
                                "library_sleep_ms")}
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
                f"ms ({step['bound_by']}); sleep timer: kernel "
                f"{step['kernel_sleep_ms']:.3f} ms (contiguous "
                f"{step['contiguous_sleep_ms']:.3f}), library "
                f"{step['library_sleep_ms']:.3f} ms")
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
    out = timings(flush, f32=lambda: chunked_matmul(x, w.view(n, k)))
    f32 = out["f32_ms"]
    log(f"  W1 {n}x{k} M=1 f32 table: K1 {f32:.4f} ms (sleep timer "
        f"{out['f32_sleep_ms']:.4f})")
    for name in ("int8", "nf4"):
        codec = CODECS[name]
        codes, scales = codec.quantise(w)
        t = timings(flush,
                    dequant=lambda: codec.dequantise(codes, scales),
                    dequant_and_k1=lambda: chunked_matmul(
                        x, codec.dequantise(codes, scales).view(n, k)))
        deq, both = t["dequant_ms"], t["dequant_and_k1_ms"]
        err = (chunked_matmul(x, codec.dequantise(codes, scales).view(n, k))
               - chunked_matmul(x, w.view(n, k))).abs().max().item()
        out[name] = {**t, "max_abs_err_vs_f32": err}
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
                 **timings(flush, kernel=c["kernel"], plain=c["plain"],
                           library=c["library"]),
                 "bound_ms": bound, "bound_by": by}
            if layout == "pos_major":
                # the executor's gather of K and V before each launch, timed
                # apart from the kernel (which reads the gathered copies)
                r.update(timings(flush, gather=lambda: (
                    (rows(ck), rows(cv)) if name == "paged_attention"
                    else (heads(ck), heads(cv)))))
            out[(name, layout)] = r
            log(f"  {name} {layout:10s} {c['shape']:24s} kernel "
                f"{r['kernel_ms']:.4f} ms"
                + (f" (+ the gather {r['gather_ms']:.4f} ms)"
                   if "gather_ms" in r else "")
                + f"  plain {r['plain_ms']:.4f} ms  library "
                f"{r['library_ms']:.4f} ms  bound {bound * 1e3:.3f} us "
                f"({by})  max|err| {err:.2e}; sleep timer: kernel "
                f"{r['kernel_sleep_ms']:.4f} ms, library "
                f"{r['library_sleep_ms']:.4f} ms")
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
                     n_heads=N_HEADS, n_kv=N_KV, d_ff=D_FF, rope_theta=THETA,
                     eps=LLAMA3_8B.eps)


def _serve_cold_requests(eng, tag: str):
    """Phase 5's request set (prompts of 32/64/32/64 tokens, 8 new tokens
    each) through ``ContinuousBatcher(max_batch=3)`` and a
    ``BatchedDecoder(prefix_block=0)``, the plans compiled before the
    requests arrive.  Every kernel's count is zeroed just before the run
    and read just after: K1 7·L + 1 a pipeline call (N − 1 more a sharded
    site), K2 L a decode tick, K3 L a prefill.  Returns the launches, the
    decoder, the KV page table and each request's prompt, tokens, TTFT
    and TPOT (ms), by request id."""
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
    served = {}
    for req in sorted(done, key=lambda r: r.rid):
        tpot = (req.done_s - req.first_token_s) / (len(req.generated) - 1)
        served[req.rid] = {"prompt": list(req.prompt),
                           "tokens": list(req.generated),
                           "ttft_ms": req.first_token_s * 1e3,
                           "tpot_ms": tpot * 1e3}
        log(f"  {tag} req{req.rid}: prompt {len(req.prompt)} tokens, ttft "
            f"{req.first_token_s * 1e3:.1f} ms, tpot {tpot * 1e3:.1f} ms, "
            f"tokens {req.generated}")
    return launches, dec, kv, served


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
    launches, dec, kv, served = _serve_cold_requests(eng, "[phase 5]")
    log(f"max memory allocated {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB")
    tick = profile_tick(dec)
    del dec, kv
    # the fixed prompt's logits, which phases 7 and 8 are held to
    fixed = _fixed_session(eng)
    log(f"fixed prompt (seed {FIXED_PROMPT_SEED}): prefill T=32 + "
        f"{FIXED_STEPS} decode steps, tokens {fixed[1]}")
    torch.cuda.empty_cache()
    return launches, eng, fixed, tick, served


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


def _gc_pauses(srv, tracer):
    """The collections of a traced server's process, from the program's
    ``gc`` spans (the flight ring's, and those the tracer recorded since
    the last tick): ``(start_us, end_us, generation)`` on the tracer's
    timeline."""
    from repro_torch.obs.trace import CAT, DUR, TS, record_arg
    spans = [(r[TS], r[TS] + r[DUR], record_arg(r, "generation"))
             for t in srv.flight.ticks() for r in t.records if r[CAT] == "gc"]
    spans += [(e.ts_us, e.ts_us + e.dur_us, e.args["generation"])
              for e in tracer.events if e.cat == "gc"]
    return sorted(spans)


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
    t0 = time.perf_counter()
    with _http_server(eng, reg, tracer,
                      drift_every=HTTP_DRIFT_EVERY) as srv:
        got = _http_streams(srv, streams, HTTP_NEW)
        preempted = srv.batcher.stats.preemptions
        traced_walls = _decode_walls(srv)
        families = _step_families(srv)
        got += _http_streams(srv, [donor], HTTP_NEW)
        got += _http_streams(srv, hits, HTTP_NEW)
        # the cyclic collector's pauses: the traced server's gc spans
        pauses = _gc_pauses(srv, tracer)
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
        "tick, top-level spans by family; steps are the host's dispatch, "
        "the wait for the card is in device_wait):")
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


def phase_http_serving(fixed, served5):
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
    for rid, r in served5.items():
        log(f"  [phase 9] req{rid}: phase 5 (ContinuousBatcher, no HTTP) "
            f"ttft {r['ttft_ms']:.1f} ms, tpot {r['tpot_ms']:.1f} ms; "
            f"through HTTP ttft "
            f"{summary['http_ttft_tpot_ms'][rid][0]:.1f} ms, tpot "
            f"{summary['http_ttft_tpot_ms'][rid][1]:.1f} ms")
    log(f"[phase 9] max memory allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    summary["max_abs_logit_traced"] = diff
    return launches, summary


def _direct_logits(eng, prompt, tokens):
    """``prompt``'s prefill through ``eng`` (a DirectEngine), then one
    decode step for each of ``tokens`` (teacher-forced): the last
    position's logits of each call on the host [1 + len(tokens), vocab]."""
    tf, cfg = eng.tf, eng.cfg
    caches = tf.init_caches(cfg, 1, eng.max_len, dtype=torch.float32,
                            device="cuda")
    lg, caches, _ = tf.prefill(eng.params, torch.tensor([prompt],
                                                        device="cuda"),
                               cfg, caches)
    logits = [lg[0, -1].cpu().numpy()]
    for i, tok in enumerate(tokens):
        lg, caches = tf.decode_step(eng.params, torch.tensor(
            [[tok]], device="cuda"), caches, len(prompt) + i, cfg)
        logits.append(lg[0, -1].cpu().numpy())
    return np.stack(logits)


def profile_direct_step(eng) -> dict:
    """Where one DirectEngine decode step (B=1, a 32-token prompt's next
    positions over a 512-row cache) spends device time
    (:func:`_profile_steps`); each step ends in the argmax's copy to the
    host, as ``generate``'s do."""
    tf, cfg = eng.tf, eng.cfg
    rng = np.random.default_rng(3)
    prompt = torch.from_numpy(rng.integers(0, VOCAB, (1, 32))).cuda()
    caches = tf.init_caches(cfg, 1, eng.max_len, dtype=torch.float32,
                            device="cuda")
    lg, caches, _ = tf.prefill(eng.params, prompt, cfg, caches)
    state = {"tok": int(torch.argmax(lg[0, -1])), "pos": 32}

    def step():
        lg, _ = tf.decode_step(eng.params, torch.tensor(
            [[state["tok"]]], device="cuda"), caches, state["pos"], cfg)
        state["tok"] = int(torch.argmax(lg[0, -1]))
        state["pos"] += 1
    for _ in range(2):  # warm: the allocator
        step()
    return _profile_steps(step, "direct decode step (B=1)")


def _families_on_the_card() -> dict:
    """Every assigned family at its TINY size, and Llama-3's: ``forward``,
    then ``prefill`` and 3 ``decode_step``s on the card against the port on
    the CPU, the same weights (drawn on the CPU, carried to the card).
    Then OLMoE-1B-7B and Mamba2-2.7B at their published widths, each cut to
    2 layers (from 16 and 64) and cast to f32 (their configs say bfloat16),
    drawn on the card and carried to the CPU.  f32 logits within 1e-4;
    returns each case's max |difference|."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import ASSIGNED
    from repro_torch.models import transformer as tf
    cases = [(a, get_config(a, tiny=True), "cpu")
             for a in ASSIGNED + ["llama3-8b"]]
    cases += [(f"{a} (published widths, 2 layers, f32)",
               dataclasses.replace(get_config(a), n_layers=2,
                                   dtype="float32", param_dtype="float32"),
               "cuda")
              for a in ("olmoe-1b-7b", "mamba2-2.7b")]
    B, T, extra = 2, 12, 3
    diffs = {}
    for name, cfg, home in cases:
        t0 = time.perf_counter()
        params = tf.init_params(cfg, 0, device=home)
        trees = {d: tf.tree_map(lambda t: t.to(d), params)
                 for d in ("cuda", "cpu")}
        del params
        gen = torch.Generator().manual_seed(1)
        toks = torch.randint(0, cfg.vocab, (B, T + extra), generator=gen)
        aux = None
        if cfg.family in ("encdec", "vlm"):
            n = cfg.n_frames if cfg.family == "encdec" else cfg.n_image_tokens
            aux = torch.randn(B, n, cfg.d_model, generator=gen)
        out = {}
        for d, p in trees.items():
            batch = {"tokens": toks.to(d)}
            if aux is not None:
                batch["frames" if cfg.family == "encdec" else "images"] = \
                    aux.to(d)
            logits = [tf.forward(p, batch, cfg)]
            caches = tf.init_caches(cfg, B, T + extra, dtype=torch.float32,
                                    device=d)
            lg, caches, ac = tf.prefill(
                p, batch["tokens"][:, :T], cfg, caches,
                aux_input=None if aux is None else aux.to(d))
            logits.append(lg)
            for i in range(extra):
                lg, caches = tf.decode_step(
                    p, batch["tokens"][:, T + i: T + i + 1], caches, T + i,
                    cfg, aux_caches=ac)
                logits.append(lg)
            out[d] = [t.cpu().numpy() for t in logits]
        for g, c in zip(out["cuda"], out["cpu"]):
            np.testing.assert_allclose(g, c, rtol=1e-4, atol=1e-4,
                                       err_msg=name)
        diffs[name] = max(float(np.abs(g - c).max())
                          for g, c in zip(out["cuda"], out["cpu"]))
        log(f"  {name} [{cfg.family}]: forward, prefill T={T} + {extra} "
            f"decode steps, card vs CPU max|diff| {diffs[name]:.3e} "
            f"({time.perf_counter() - t0:.1f} s)")
        del trees, out
    return diffs


def phase_direct(fixed, served5, tick5, h2d_rate: float) -> dict:
    """The paper's dense baseline on the card: ``DirectEngine`` over the
    model stack at Llama-3-8B width and depth, from phase 5's weights
    (``init_llama_tensors`` with the same seed on the same card) through
    the bridge.  (a) in memory: the fixed prompt held to phase 5's logits,
    phase 5's requests held to its tokens, TTFT and TPOT beside phase 5's,
    a decode step profiled; (b) paged from pinned host memory through phase
    7's 16 GiB budget, without prefetch: one request's tokens equal (a)'s;
    (c) every family on the card against the CPU.  No K1-K3 launch."""
    from repro_torch import kernels
    from repro_torch.core.bridge import llama_params_to_tree, spec_to_config
    from repro_torch.core.llama_graph import init_llama_tensors
    from repro_torch.models.transformer import tree_leaves, tree_map
    from repro_torch.serving.engine import DirectEngine
    log(f"== phase 10: the dense baseline (DirectEngine) at Llama-3-8B "
        f"width, {N_LAYERS} layers, on the card")
    wrappers = [getattr(kernels, name) for name in KERNELS]
    for fn in wrappers:
        fn.launches = fn.calls = 0
    spec = _spec(N_LAYERS)
    cfg = spec_to_config(spec)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tables = init_llama_tensors(spec, seed=0, device="cuda")
    tree = llama_params_to_tree(tables, spec, device="cuda")
    del tables
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(tree))
    log(f"(a) phase 5's weights drawn and carried through the bridge in "
        f"{time.perf_counter() - t0:.1f} s: {n_params / 1e9:.3f} B "
        f"parameters, {4 * n_params / 1e9:.2f} GB f32 tree; max memory "
        f"allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB (the "
        f"tables and the tree together)")
    eng = DirectEngine(cfg, tree, max_len=512, device="cuda")
    del tree
    ref_logits, ref_tokens = fixed
    prompt = [int(t) for t in np.random.default_rng(
        FIXED_PROMPT_SEED).integers(0, VOCAB, 32)]
    diff = _assert_logits(_direct_logits(eng, prompt, ref_tokens),
                          ref_logits)
    log(f"(a) fixed prompt, prefill T=32 + {FIXED_STEPS} decode steps fed "
        f"phase 5's tokens: max|Δlogit| against phase 5's relational "
        f"engine {diff:.3e}")
    eng.generate(served5[0]["prompt"][:8], 2)  # warm: cuBLAS, allocator
    walls, diverged = {}, {}
    for rid, r in served5.items():
        res = eng.generate(r["prompt"], len(r["tokens"]))
        walls[rid] = (res.ttft_s * 1e3, res.tpot_s * 1e3)
        i = next((j for j, (a, b) in enumerate(zip(res.tokens, r["tokens"]))
                  if a != b), None)
        if i is not None:  # the top-2 margin there, fed phase 5's tokens
            top2 = np.sort(_direct_logits(eng, r["prompt"],
                                          r["tokens"][:i])[-1])[-2:]
            margin = float(top2[1] - top2[0])
            assert margin <= 1e-3, (rid, i, margin, res.tokens, r["tokens"])
            diverged[rid] = (i, margin)
        log(f"  (a) req{rid}: prompt {len(r['prompt'])} tokens, direct ttft "
            f"{walls[rid][0]:.1f} ms, tpot {walls[rid][1]:.1f} ms; phase 5 "
            f"(relational, ContinuousBatcher) ttft {r['ttft_ms']:.1f} ms, "
            f"tpot {r['tpot_ms']:.1f} ms; tokens {res.tokens}"
            + ("" if i is None else f" (first differs from phase 5's at "
               f"step {i}, top-2 margin {diverged[rid][1]:.2e})"))
    step = profile_direct_step(eng)
    if step["busy_ms"] is not None and tick5["busy_ms"] is not None:
        log(f"(a) direct decode step (B=1) against phase 5's relational tick "
            f"(B=3, bucket 4): host wall {step['wall_ms']:.2f} against "
            f"{tick5['wall_ms']:.2f} ms, device busy {step['busy_ms']:.2f} "
            f"against {tick5['busy_ms']:.2f} ms, idle share "
            f"{step['idle_share']:.3f} against {tick5['idle_share']:.3f}")
    in_memory_peak = torch.cuda.max_memory_allocated()
    log(f"(a) max memory allocated {in_memory_peak / 1e9:.2f} GB")
    tokens_a = eng.generate(served5[0]["prompt"],
                            len(served5[0]["tokens"])).tokens

    # (b) paged from pinned host memory, phase 7's budget, no prefetch
    t0 = time.perf_counter()
    host = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          pin_memory=True).copy_(t),
                    eng.params)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    paged = DirectEngine(cfg, host, residency="paged",
                         budget_bytes=PAGED_BUDGET, max_len=512,
                         device="cuda")
    log(f"(b) the tree copied to pinned host memory and registered in "
        f"{time.perf_counter() - t0:.1f} s: "
        f"{paged.pager.total_cold_bytes() / 1e9:.2f} GB cold, budget "
        f"{PAGED_BUDGET / 2**30:.0f} GiB, pager policy "
        f"{paged.pager.policy}")
    n_new = len(served5[0]["tokens"])
    res = paged.generate(served5[0]["prompt"], n_new)
    assert res.tokens == tokens_a, (res.tokens, tokens_a)
    stats = res.pager_stats
    assert stats["peak_bytes"] <= PAGED_BUDGET and stats["evictions"] > 0
    per_token = stats["bytes_loaded"] / n_new
    bound_ms = per_token / h2d_rate * 1e3
    paged_peak = torch.cuda.max_memory_allocated()
    log(f"(b) req0 paged: tokens equal (a)'s; ttft {res.ttft_s * 1e3:.1f} "
        f"ms, tpot {res.tpot_s * 1e3:.1f} ms; {per_token / 1e9:.2f} GB "
        f"streamed a token ({n_new} tree pulls), a bound of {bound_ms:.1f} "
        f"ms a token at phase 7's pinned {h2d_rate / 1e9:.2f} GB/s; pager "
        f"hits {stats['hits']}, misses {stats['misses']}, evictions "
        f"{stats['evictions']}; peak held {stats['peak_bytes'] / 1e9:.2f} "
        f"GB (<= budget), max memory allocated {paged_peak / 1e9:.2f} GB "
        f"(each pull holds the whole tree, as the reference's does)")
    del paged, host
    gc.collect()
    torch.cuda.empty_cache()
    _release_pinned()

    log("(c) the model families on the card against the CPU")
    families = _families_on_the_card()
    launched = {name: fn.launches for name, fn in zip(KERNELS, wrappers)}
    assert not any(launched.values()), launched
    log(f"K1-K3 launches in phase 10: {launched} (the dense path runs none)")
    return {"max_abs_logit": diff, "walls_ms": walls,
            "diverged": diverged, "step": step,
            "in_memory_max_allocated": in_memory_peak,
            "paged": {"ttft_ms": res.ttft_s * 1e3,
                      "tpot_ms": res.tpot_s * 1e3, "pager": stats,
                      "bytes_a_token": per_token, "bound_ms": bound_ms,
                      "max_allocated": paged_peak},
            "families_max_abs_diff": families}


def _train_batch(data, i):
    return {k: torch.from_numpy(v).cuda() for k, v in data.batch_at(i).items()}


def _events_ms(fn, reps: int = 3) -> list:
    """Device-synchronised walls of ``fn`` by CUDA events, one a run."""
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def _grads(params, batch, cfg):
    """(loss, gradient leaves in ``tree_leaves`` order) of ``loss_fn``."""
    from repro_torch.models import transformer as tf
    from repro_torch.training.train_loop import loss_fn
    live = [p.detach().requires_grad_(True) for p in tf.tree_leaves(params)]
    with torch.enable_grad():
        loss, _ = loss_fn(tf.tree_unflatten(params, live), batch, cfg)
        return loss.detach(), list(torch.autograd.grad(loss, live))


def _train_full(cfg) -> dict:
    """(a) Llama-3.2-3B at full width and depth: 1 + TRAIN_STEPS steps
    through ``make_train_step``, each synchronised by its loss's copy to
    the host; one step profiled; the clip and the update timed apart."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as tf
    from repro_torch.training.optimizer import AdamW, clip_by_global_norm
    from repro_torch.training.train_loop import make_train_step
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, 0, device="cuda")
    opt = AdamW()
    state = opt.init(params)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tf.tree_leaves(params))
    n_layers = sum(t.numel() for t in tf.tree_leaves(params["g0"]))
    log(f"(a) {cfg.name}: {n / 1e9:.3f} B parameters ({n_layers / 1e9:.3f} "
        f"B in the {cfg.n_layers} layers), {cfg.param_dtype} params, "
        f"{opt.state_dtype} moments, remat={cfg.remat!r}, "
        f"ce_impl={cfg.ce_impl!r}; drawn and AdamW state made in "
        f"{time.perf_counter() - t0:.1f} s, memory allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    step = make_train_step(cfg, opt)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                       global_batch=TRAIN_BATCH)
    losses, gnorms, walls = [], [], []
    for i in range(1 + TRAIN_STEPS):
        batch = _train_batch(data, i)
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))  # the step's synchronise
        walls.append((time.perf_counter() - t0) * 1e3)
        gnorms.append(float(m["grad_norm"]))
        log(f"  step {i}{' (warm-up)' if i == 0 else ''}: loss "
            f"{losses[-1]:.4f}, grad_norm {gnorms[-1]:.4f}, lr "
            f"{float(m['lr']):.3e}, wall {walls[-1]:.1f} ms")
    peak = torch.cuda.max_memory_allocated()
    assert all(math.isfinite(x) for x in losses + gnorms), (losses, gnorms)
    # random weights: the final norm's rows have unit RMS and lm_head's
    # columns a 1/d variance, so the logits are ~N(0, 1) and the first
    # loss E[logsumexp] - E[gold] is ln(vocab) + 1/2
    first_want = math.log(cfg.vocab) + 0.5
    assert abs(losses[0] - first_want) <= 0.1, (losses[0], first_want)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    wall = statistics.median(walls[1:])
    model_flops = 6 * n * tokens
    recompute_flops = 2 * n_layers * tokens
    peak_rate = TENSOR_PEAKS[torch.bfloat16]
    out = {"n_params": n, "losses": losses, "grad_norms": gnorms,
           "step_walls_ms": walls[1:], "step_wall_ms": wall,
           "tokens_per_s": tokens / wall * 1e3,
           "model_tflop": model_flops / 1e12,
           "recompute_tflop": recompute_flops / 1e12,
           "mfu": model_flops / (wall / 1e3) / peak_rate,
           "hfu_with_recompute": (model_flops + recompute_flops)
           / (wall / 1e3) / peak_rate,
           "max_memory_allocated": peak}
    log(f"(a) {TRAIN_STEPS} timed steps of {tokens} tokens: median wall "
        f"{wall:.1f} ms (min {min(walls[1:]):.1f}, max {max(walls[1:]):.1f})"
        f", {out['tokens_per_s']:.0f} tokens/s; 6·N·tokens = "
        f"{out['model_tflop']:.2f} TFLOP a step, {out['mfu']:.4f} of the "
        f"{peak_rate / 1e12:.0f} TFLOP/s bf16 peak (with remat's "
        f"{out['recompute_tflop']:.2f} TFLOP recompute: "
        f"{out['hfu_with_recompute']:.4f}); first loss {losses[0]:.4f} "
        f"against ln(vocab) + 1/2 = {first_want:.4f}; max memory "
        f"allocated {peak / 1e9:.2f} GB")

    def one_step():
        nonlocal params, state
        params, state, m = step(params, state, _train_batch(data, 0))
        float(m["loss"])
    out["profile"] = _profile_steps(one_step, "train step")

    # the step's parts, timed apart on its shapes: the gradient (forward,
    # recompute, backward), the clip and the AdamW update
    batch = _train_batch(data, 0)
    grad_ms = _events_ms(lambda: _grads(params, batch, cfg), reps=2)
    _, leaves = _grads(params, batch, cfg)
    grads = tf.tree_unflatten(params, leaves)
    clip_ms = _events_ms(lambda: clip_by_global_norm(grads, 1.0))
    update_ms = _events_ms(lambda: opt.update(grads, state, params))
    out.update(grad_ms=statistics.median(grad_ms),
               clip_ms=statistics.median(clip_ms),
               update_ms=statistics.median(update_ms))
    out["update_share"] = out["update_ms"] / wall
    out["clip_share"] = out["clip_ms"] / wall
    log(f"(a) the step's parts by CUDA events: gradient (forward, remat "
        f"recompute, backward) {out['grad_ms']:.1f} ms, clip "
        f"{out['clip_ms']:.1f} ms ({out['clip_share']:.3f} of the step), "
        f"AdamW update {out['update_ms']:.1f} ms ({out['update_share']:.3f} "
        f"of the step); runs {grad_ms}, {clip_ms}, {update_ms}")
    return out


def _train_parity(cfg3b) -> dict:
    """(b) Llama-3.2-3B's width at depth 2 in f32, B = 1, T = PARITY_T:
    the card against the port on the CPU, from the same weights (drawn on
    the CPU).  Loss within 1e-5, each gradient leaf within 1e-4 of that
    leaf's largest |gradient|, remat="full" equal to remat="none" on the
    card within 1e-6, and one train step's params within 1e-5 outside
    Adam's ±lr sign flips."""
    import dataclasses
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as tf
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_loop import make_train_step
    base = dataclasses.replace(cfg3b, n_layers=2, dtype="float32",
                               param_dtype="float32")
    cfgs = {r: dataclasses.replace(base, remat=r) for r in ("none", "full")}
    t0 = time.perf_counter()
    cpu_p = tf.init_params(base, 0, device="cpu")
    gpu_p = tf.tree_map(lambda t: t.cuda(), cpu_p)
    data = SyntheticLM(vocab=base.vocab, seq_len=PARITY_T, global_batch=1)
    host = {k: torch.from_numpy(v) for k, v in data.batch_at(0).items()}
    dev = {k: v.cuda() for k, v in host.items()}
    card = {r: _grads(gpu_p, dev, cfgs[r]) for r in cfgs}
    cpu_loss, cpu_grads = _grads(cpu_p, host, cfgs["none"])
    loss_diff = abs(float(card["none"][0]) - float(cpu_loss))
    grad_rel = max(float((g.cpu() - c).abs().max())
                   / max(float(c.abs().max()), 1e-30)
                   for g, c in zip(card["none"][1], cpu_grads))
    remat_diff = max(float((a - b).abs().max()) for a, b in zip(
        [card["none"][0]] + card["none"][1],
        [card["full"][0]] + card["full"][1]))
    assert loss_diff <= 1e-5, loss_diff
    assert grad_rel <= 1e-4, grad_rel
    assert remat_diff <= 1e-6, remat_diff
    del card, cpu_grads
    opt = AdamW(lr=PARITY_LR, warmup_steps=1)
    step = make_train_step(cfgs["full"], opt)
    ms = {}
    for name, p, b in (("cuda", gpu_p, dev), ("cpu", cpu_p, host)):
        _, _, ms[name] = step(p, opt.init(p), b)
    flips, worst = 0, 0.0
    for g, c in zip(tf.tree_leaves(gpu_p), tf.tree_leaves(cpu_p)):
        diff = (g.cpu() - c).abs()
        flips += int((diff > 1e-5).sum())
        worst = max(worst, float(diff.max()))
        assert float((diff > 1e-5).float().mean()) <= 1e-3
    assert worst <= 2 * PARITY_LR * (1 + 1e-4) + 1e-5, worst
    step_diff = {k: abs(float(ms["cuda"][k]) - float(ms["cpu"][k]))
                 for k in ("loss", "grad_norm", "lr")}
    assert step_diff["loss"] <= 1e-5, step_diff
    assert step_diff["lr"] <= 1e-6 * PARITY_LR, step_diff
    n = sum(t.numel() for t in tf.tree_leaves(cpu_p))
    out = {"n_params": n, "loss_abs_diff": loss_diff,
           "grad_max_rel_diff": grad_rel, "remat_max_abs_diff": remat_diff,
           "step_metric_abs_diff": step_diff, "step_sign_flips": flips,
           "step_max_abs_param_diff": worst}
    log(f"(b) width {base.d_model}, 2 layers, f32 ({n / 1e9:.3f} B "
        f"parameters), B=1, T={PARITY_T}, card against CPU: |Δloss| "
        f"{loss_diff:.3e} (≤ 1e-5), gradients' max |Δ| / leaf max "
        f"{grad_rel:.3e} (≤ 1e-4), remat full vs none on the card max |Δ| "
        f"{remat_diff:.3e} (≤ 1e-6); one train step (lr {PARITY_LR}): "
        f"|Δloss| {step_diff['loss']:.3e}, |Δgrad_norm| "
        f"{step_diff['grad_norm']:.3e}, params beyond 1e-5: {flips} of {n}, "
        f"max |Δ| {worst:.3e} ({time.perf_counter() - t0:.1f} s)")
    return out


@contextlib.contextmanager
def _timed_checkpoints(times: dict):
    """Record the seconds of the checkpoint module's calls as the recovery
    driver makes them: the host copy in ``AsyncCheckpointer.save`` (after
    its wait), the writer thread's ``save``, each ``wait`` and each
    ``restore``."""
    from repro_torch.training import checkpoint as ck
    saved = (ck.save, ck.restore, ck.AsyncCheckpointer.save,
             ck.AsyncCheckpointer.wait)

    def timing(name, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                times.setdefault(name, []).append(time.perf_counter() - t0)
        return run

    def host_copy(self, *a, **k):
        self.wait()
        return timing("host_copy", saved[2])(self, *a, **k)
    ck.save = timing("write", saved[0])
    ck.restore = timing("restore", saved[1])
    ck.AsyncCheckpointer.save = host_copy
    ck.AsyncCheckpointer.wait = timing("wait", saved[3])
    try:
        yield
    finally:
        (ck.save, ck.restore, ck.AsyncCheckpointer.save,
         ck.AsyncCheckpointer.wait) = saved


def _train_recovery(cfg3b) -> dict:
    """(c) The recovery driver at Llama-3.2-3B's width, 2 layers, the
    config's defaults (bf16, remat): RECOVERY_STEPS steps uninterrupted,
    then again with a crash at step RECOVERY_FAIL_AT, checkpoints every
    RECOVERY_EVERY steps (keep 1) under build/; the final losses equal
    (abs 1e-6, the reference's bar)."""
    import dataclasses
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as tf
    from repro_torch.training.fault_tolerance import (FaultConfig,
                                                      run_with_recovery)
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_loop import make_train_step
    cfg = dataclasses.replace(cfg3b, n_layers=2)
    opt = AdamW()
    step = make_train_step(cfg, opt)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                       global_batch=TRAIN_BATCH)

    def init_state():
        p = tf.init_params(cfg, 0, device="cuda")
        return p, opt.init(p)

    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    free = shutil.disk_usage(ROOT).free
    runs, times, ckpt_bytes = {}, {}, 0
    try:
        for name, fail_at in (("uninterrupted", None),
                              ("restarted", {RECOVERY_FAIL_AT: 0})):
            d = TRAIN_CKPT_DIR / name
            t0 = time.perf_counter()
            with _timed_checkpoints(times.setdefault(name, {})):
                runs[name] = run_with_recovery(
                    step, init_state, lambda i: _train_batch(data, i),
                    total_steps=RECOVERY_STEPS,
                    fault_cfg=FaultConfig(ckpt_dir=str(d),
                                          ckpt_every=RECOVERY_EVERY, keep=1),
                    fail_at=fail_at)
            times[name]["run"] = time.perf_counter() - t0
            last = d / f"step_{RECOVERY_STEPS:08d}"
            ckpt_bytes = sum(f.stat().st_size for f in last.iterdir())
            shutil.rmtree(d)
    finally:
        shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    ref, rec = runs["uninterrupted"], runs["restarted"]
    assert (ref.restarts, rec.restarts) == (0, 1)
    assert ref.steps_run == rec.steps_run == RECOVERY_STEPS
    assert all(math.isfinite(x) for x in ref.losses + rec.losses)
    assert abs(rec.losses[-1] - ref.losses[-1]) <= 1e-6, (ref.losses,
                                                           rec.losses)
    out = {"losses": {k: r.losses for k, r in runs.items()},
           "checkpoint_bytes": ckpt_bytes, "disk_free_bytes": free,
           "seconds": times}
    log(f"(c) recovery at width {cfg.d_model}, 2 layers, {cfg.param_dtype}: "
        f"uninterrupted losses {ref.losses}, restarted {rec.losses} "
        f"(final equal, abs 1e-6); a checkpoint {ckpt_bytes / 1e9:.2f} GB "
        f"(disk free {free / 1e9:.0f} GB)")
    for name, t in times.items():
        log(f"  {name}: " + ", ".join(
            f"{k} {[round(x, 2) for x in v] if k != 'run' else round(v, 1)} s"
            for k, v in t.items()))
    return out


def phase_train() -> dict:
    """The trainer on the card: (a) Llama-3.2-3B at full width and depth,
    (b) its width at depth 2 in f32 against the CPU, (c) the recovery
    driver at depth 2.  The training path launches none of K1-K3."""
    from repro_torch import kernels
    from repro_torch.configs.llama3_2_3b import CONFIG
    log(f"== phase 11: the trainer, {CONFIG.name} at full width and "
        f"{CONFIG.n_layers} layers, on the card (memory allocated at the "
        f"start {torch.cuda.memory_allocated() / 1e9:.2f} GB)")
    wrappers = [getattr(kernels, name) for name in KERNELS]
    for fn in wrappers:
        fn.launches = fn.calls = 0
    out = {"full": _train_full(CONFIG)}
    gc.collect()
    torch.cuda.empty_cache()
    out["parity"] = _train_parity(CONFIG)
    gc.collect()
    torch.cuda.empty_cache()
    out["recovery"] = _train_recovery(CONFIG)
    gc.collect()
    torch.cuda.empty_cache()
    launched = {name: fn.launches for name, fn in zip(KERNELS, wrappers)}
    assert not any(launched.values()), launched
    log(f"K1-K3 launches in phase 11: {launched} (the training path runs "
        f"none)")
    return out


@contextlib.contextmanager
def _world_of_one():
    """A one-rank NCCL process group whose rendezvous is a FileStore under
    build/ (no network); destroyed on exit."""
    import torch.distributed as dist
    DIST_STORE.parent.mkdir(parents=True, exist_ok=True)
    DIST_STORE.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(DIST_STORE), 1),
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        yield
    finally:
        dist.destroy_process_group()
        DIST_STORE.unlink(missing_ok=True)


def _dist_train(cfg, first_loss: float, train11: dict):
    """(a) ``make_train_step`` on DTensor trees placed by ``param_pspecs``
    on a (1, 1) mesh under single_pod_rules(fsdp=True); the first loss
    equal to phase 11's (1e-6); one step profiled beside phase 11's.
    Returns (summary, params)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.sharding import (
        distribute_tree, placements, sharding_rules, single_pod_rules)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_loop import (batch_pspec,
                                                 make_train_step,
                                                 param_pspecs)
    mesh = make_test_mesh(1, 1)
    torch.cuda.reset_peak_memory_stats()
    opt = AdamW()
    step = make_train_step(cfg, opt)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                       global_batch=TRAIN_BATCH)
    losses, walls = [], []
    with sharding_rules(mesh, single_pod_rules(fsdp=True)):
        params = tf.init_params(cfg, 0, device="cuda")
        specs = param_pspecs(params, mesh)
        params = distribute_tree(params, specs, mesh)
        state = opt.init(params)
        for tree in (params, state.m, state.v):
            for t, s in zip(tf.tree_leaves(tree), tf.tree_leaves(specs)):
                assert isinstance(t, DTensor), type(t)
                assert tuple(t.placements) == placements(s, mesh), (
                    t.placements, s)
        bpl = placements(batch_pspec(), mesh)

        def batch_at(i):
            return {k: distribute_tensor(torch.from_numpy(v).to("cuda"),
                                         mesh, bpl)
                    for k, v in data.batch_at(i).items()}
        for i in range(DIST_WARMUP + DIST_STEPS):
            batch = batch_at(i)
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            losses.append(m["loss"].full_tensor().item())  # the synchronise
            walls.append((time.perf_counter() - t0) * 1e3)
            log(f"  step {i}{' (warm-up)' if i < DIST_WARMUP else ''}: loss "
                f"{losses[-1]:.6f}, wall {walls[-1]:.1f} ms")
        peak = torch.cuda.max_memory_allocated()

        def one_step():
            nonlocal params, state
            params, state, m = step(params, state, batch_at(0))
            m["loss"].full_tensor().item()
        profile = _profile_steps(one_step, "sharded train step")
    diff = abs(losses[0] - first_loss)
    log(f"(a) first loss {losses[0]!r} against phase 11's {first_loss!r}: "
        f"|diff| {diff!r}")
    assert diff <= 1e-6, (losses[0], first_loss)
    assert all(math.isfinite(x) for x in losses), losses
    wall = statistics.median(walls[DIST_WARMUP:])
    wall11 = train11["step_wall_ms"]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = {"losses": losses, "step_walls_ms": walls[DIST_WARMUP:],
           "step_wall_ms": wall, "tokens_per_s": tokens / wall * 1e3,
           "wall_over_phase11": wall / wall11,
           "first_loss_diff": diff, "max_memory_allocated": peak,
           "profile": profile}
    log(f"(a) {DIST_STEPS} timed steps on DTensor leaves: median wall "
        f"{wall:.1f} ms (min {min(walls[DIST_WARMUP:]):.1f}, max "
        f"{max(walls[DIST_WARMUP:]):.1f}), {out['tokens_per_s']:.0f} "
        f"tokens/s, {out['wall_over_phase11']:.3f} x phase 11's median "
        f"{wall11:.1f} ms; max memory allocated {peak / 1e9:.2f} GB")
    busy, busy11 = profile["busy_ms"], train11["profile"]["busy_ms"]
    if busy is not None and busy11 is not None:
        out["busy_over_phase11"] = busy / busy11
        log(f"(a) one profiled step: device busy {busy:.1f} ms, idle share "
            f"{profile['idle_share']:.3f}, against phase 11's busy "
            f"{busy11:.1f} ms, idle share "
            f"{train11['profile']['idle_share']:.3f} "
            f"({busy / busy11:.3f} x its busy time)")
    del state
    return out, params


def _dist_collectives() -> dict:
    """(b) The collectives at world size 1: the int8 error-feedback
    all-reduce (mean within half a quantisation step of g, a nonzero
    residual), the hierarchical psum (equal to its input) and a one-stage
    pipeline (the dense loop's output and gradients, each within 1e-5 of
    its largest magnitude)."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.collectives import (
        ef_int8_allreduce, hierarchical_psum, init_error_state)
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_test_mesh
    gen = torch.Generator(device="cuda").manual_seed(12)
    mesh2 = make_test_mesh(1, 1)
    mesh3 = make_test_mesh(1, 1, pods=1)
    g = torch.randn(EF_SHAPE, generator=gen, device="cuda") * EF_STD
    t0 = time.perf_counter()
    mean_g, err = ef_int8_allreduce(
        g, init_error_state({"g": g})["g"], mesh2, ("data",))
    torch.cuda.synchronize()
    ef_s = time.perf_counter() - t0
    half_step = (g.abs().max() / 127.0 / 2).item()
    ef_err = (mean_g - g).abs().max().item()
    residual = err.abs().max().item()
    # f32 division rounds |g / scale| <= 127 to within ~1.5e-5 of a step
    assert ef_err <= half_step * (1 + 1e-4) and ef_err < 2e-3, (
        ef_err, half_step)
    assert residual > 0
    h = hierarchical_psum(g, mesh3, "pod", "data")
    assert torch.equal(h, g)

    pmesh = init_device_mesh("cuda", (1,), mesh_dim_names=("pod",))
    w = torch.randn((PIPE_L, PIPE_D, PIPE_D), generator=gen,
                    device="cuda") * PIPE_D ** -0.5
    x = torch.randn((PIPE_B, PIPE_D), generator=gen, device="cuda")
    cot = torch.randn((PIPE_B, PIPE_D), generator=gen, device="cuda")

    def block_fn(p, x):
        return torch.tanh(x @ p["w"])
    wp, xp = w.clone().requires_grad_(True), x.clone().requires_grad_(True)
    piped = pipeline_apply(block_fn, {"w": wp}, xp, pmesh, stage_axis="pod",
                           n_micro=PIPE_MICRO)
    (piped * cot).sum().backward()
    wd, xd = w.clone().requires_grad_(True), x.clone().requires_grad_(True)
    dense = xd
    for i in range(PIPE_L):
        dense = block_fn({"w": wd[i]}, dense)
    (dense * cot).sum().backward()
    # cuBLAS picks its kernel by shape, so a 16-row microbatch sums in
    # another order than the 64-row batch: each result within 1e-5 of its
    # largest magnitude
    pipe = {k: ((a - b).abs().max() / b.abs().max()).item()
            for k, (a, b) in {"out": (piped, dense),
                              "grad_w": (wp.grad, wd.grad),
                              "grad_x": (xp.grad, xd.grad)}.items()}
    assert all(v <= 1e-5 for v in pipe.values()), pipe
    out = {"ef_int8_max_err": ef_err, "ef_half_step": half_step,
           "ef_residual_max": residual, "ef_s": ef_s,
           "pipeline_rel_diff": pipe}
    log(f"(b) int8 EF all-reduce of {list(EF_SHAPE)} f32 (std {EF_STD}): "
        f"max |mean - g| {ef_err:.3e} (half a step {half_step:.3e}), "
        f"residual max {residual:.3e}, {ef_s * 1e3:.1f} ms; hierarchical "
        f"psum on (1, 1, 1) = its input; one-stage pipeline against the "
        f"dense loop, max |Δ| / max |dense| {pipe}")
    return out


def _dist_reshard(params) -> dict:
    """(c) The elastic reshard: (a)'s params saved from the (1, 1) mesh,
    restored onto (1, 1, 1) under multi_pod_rules(fsdp=True): equal, and
    the manifest byte-equal to an unsharded save's."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.sharding import (
        NamedSharding, multi_pod_rules, placements, sharding_rules)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.train_loop import param_pspecs
    mesh3 = make_test_mesh(1, 1, pods=1)
    whole = tf.tree_map(lambda t: t.full_tensor(), params)
    abstract = tf.tree_map(lambda t: torch.empty_like(t, device="meta"),
                           whole)
    with sharding_rules(mesh3, multi_pod_rules(fsdp=True)):
        specs3 = param_pspecs(abstract, mesh3)
    shardings = tf.tree_map(
        lambda s: NamedSharding(mesh3, placements(s, mesh3)), specs3)
    shutil.rmtree(DIST_CKPT_DIR, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        sharded = Path(ckpt.save(str(DIST_CKPT_DIR / "sharded"), 1, params))
        save_s = time.perf_counter() - t0
        plain = Path(ckpt.save(str(DIST_CKPT_DIR / "plain"), 1, whole))
        manifest_equal = ((sharded / "manifest.json").read_bytes()
                          == (plain / "manifest.json").read_bytes())
        nbytes = sum(f.stat().st_size for f in sharded.iterdir())
        t0 = time.perf_counter()
        restored, _ = ckpt.restore(str(DIST_CKPT_DIR / "sharded"), 1,
                                   abstract, shardings)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(DIST_CKPT_DIR, ignore_errors=True)
    assert manifest_equal
    for t, s in zip(tf.tree_leaves(restored), tf.tree_leaves(specs3)):
        assert isinstance(t, DTensor)
        assert tuple(t.placements) == placements(s, mesh3)
    equal = all(torch.equal(a.full_tensor(), b) for a, b in zip(
        tf.tree_leaves(restored), tf.tree_leaves(whole)))
    assert equal
    out = {"checkpoint_bytes": nbytes, "save_s": save_s,
           "restore_s": restore_s}
    log(f"(c) elastic reshard (1, 1) -> (1, 1, 1): {nbytes / 1e9:.2f} GB "
        f"saved in {save_s:.2f} s, restored in {restore_s:.2f} s, equal, "
        f"manifest byte-equal to an unsharded save")
    return out


def _dist_explicit_shards() -> dict:
    """(d) The Shard and Partial paths over NCCL.  On a (1, 1) mesh
    ``param_pspecs`` drops every size-1 axis, so (a) places every leaf
    ``Replicate``; here the tiny Llama's f32 params take the placements of
    their 2x2 fsdp specs on the (1, 1) mesh's dims (explicit ``Shard``s of
    size 1), and one step on them equals the plain step (loss 1e-6,
    params 1e-5): FSDP's gather at use, sharded matmuls, ``Partial`` sums
    and the norm's reduction all run as NCCL collectives."""
    import types
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.sharding import (
        distribute_tree, placements, sharding_rules, single_pod_rules)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_loop import (batch_pspec,
                                                 make_train_step,
                                                 param_pspecs)
    cfg = get_config("llama3-8b", tiny=True)
    rules = single_pod_rules(fsdp=True)
    mesh = make_test_mesh(1, 1)
    # param_pspecs reads only the mesh's axis names and sizes
    wide = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(2, 2))
    opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=10)
    params = tf.init_params(cfg, 0, device="cuda")
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in
             SyntheticLM(vocab=cfg.vocab, seq_len=16,
                         global_batch=8).batch_at(0).items()}
    with sharding_rules(wide, rules):
        specs = param_pspecs(params, wide)
    plain = tf.tree_map(lambda t: t.clone(), params)
    want_p, _, want_m = make_train_step(cfg, opt)(plain, opt.init(plain),
                                                  batch)
    with sharding_rules(mesh, rules):
        psh = distribute_tree(params, specs, mesh)
        n_sharded = sum(any(q.is_shard() for q in t.placements)
                        for t in tf.tree_leaves(psh))
        bpl = placements(batch_pspec(), mesh)
        got_p, _, got_m = make_train_step(cfg, opt)(
            psh, opt.init(psh),
            {k: distribute_tensor(v, mesh, bpl) for k, v in batch.items()})
        loss = got_m["loss"].full_tensor().item()
    loss_diff = abs(loss - want_m["loss"].item())
    param_diff = max((a.full_tensor() - b).abs().max().item() for a, b in
                     zip(tf.tree_leaves(got_p), tf.tree_leaves(want_p)))
    n_leaves = len(list(tf.tree_leaves(psh)))
    assert n_sharded > 0
    assert loss_diff <= 1e-6 and param_diff <= 1e-5, (loss_diff, param_diff)
    log(f"(d) {cfg.name} f32 with its 2x2 fsdp placements on the (1, 1) "
        f"mesh ({n_sharded} of {n_leaves} leaves hold a Shard): one step "
        f"against the plain step, loss |diff| {loss_diff!r}, params max "
        f"|diff| {param_diff!r}")
    return {"leaves_sharded": n_sharded, "leaves": n_leaves,
            "loss_diff": loss_diff, "param_diff": param_diff}


def phase_distributed(train_summary: dict) -> dict:
    """The distributed path on the card at world size 1 over NCCL: (a) the
    sharded train step at phase 11's width, depth and batches, (b) the
    collectives and the pipeline, (c) the elastic reshard, (d) a small
    step on explicit Shard placements.  It launches none of K1-K3."""
    from repro_torch import kernels
    from repro_torch.configs.llama3_2_3b import CONFIG
    full = train_summary["full"]
    log(f"== phase 12: the distributed path, {CONFIG.name} on a (1, 1) "
        f"DeviceMesh at world size 1 (nccl)")
    wrappers = [getattr(kernels, name) for name in KERNELS]
    for fn in wrappers:
        fn.launches = fn.calls = 0
    with _world_of_one():
        out = {}
        out["train"], params = _dist_train(CONFIG, full["losses"][0], full)
        out["reshard"] = _dist_reshard(params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        out["collectives"] = _dist_collectives()
        out["explicit_shards"] = _dist_explicit_shards()
    launched = {name: fn.launches for name, fn in zip(KERNELS, wrappers)}
    assert not any(launched.values()), launched
    log(f"K1-K3 launches in phase 12: {launched} (the distributed path runs "
        f"none)")
    return out


def _dryrun_cells() -> dict:
    """(a) The dry-run's cells, one subprocess each, run together; each
    must exit 0.  Prints the roofline table and each cell's host seconds."""
    from repro_torch.analysis.roofline import format_table
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    DRYRUN_DIR.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    argvs = [["-m", "repro_torch.launch.dryrun", *cell, "--out",
              str(DRYRUN_DIR / f"cells{i}.jsonl")]
             for i, cell in enumerate(DRYRUN_CELLS)]
    argvs.append(["-m", "repro_torch.launch.hillclimb", DRYRUN_HILLCLIMB])
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, *argv], cwd=DRYRUN_DIR,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for argv in argvs]
    try:
        outs = [p.communicate(timeout=DRYRUN_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    for argv, p, out in zip(argvs, procs, outs):
        shown = argv[:-2] if argv[-2] == "--out" else argv
        log(f"  $ python {' '.join(shown)} -> exit {p.returncode}")
        for line in out.splitlines():
            if line.startswith(("[OK]", "[FAIL]", "     roofline",
                                "     cost", "dry-run complete")):
                log(f"    {line.strip()}")
        assert p.returncode == 0, out[-4000:]
    recs = [json.loads(line) for f in sorted(DRYRUN_DIR.rglob("*.jsonl"))
            for line in f.read_text().splitlines()]
    for r in recs:
        log(f"  {r['arch']} x {r['shape']} x {r['mesh']}"
            f"{' [' + r['tag'] + ']' if r.get('tag') else ''}: "
            f"{r['status']}" + (f", host {r['compile_seconds']:.2f} s, "
                                f"memory {r['memory_analysis']}"
                                if r["status"] == "ok" else
                                f" ({r.get('reason') or r.get('error')})"))
    status = {(r["arch"], r["shape"], r["mesh"], r.get("tag", "")):
              r["status"] for r in recs}
    assert status == {
        ("olmo-1b", "decode_32k", "16x16", ""): "ok",
        ("olmo-1b", "decode_32k", "2x16x16", ""): "ok",
        ("olmoe-1b-7b", "prefill_32k", "16x16", ""): "ok",
        ("olmo-1b", "long_500k", "16x16", ""): "skipped",
        ("olmoe-1b-7b", "prefill_32k", "16x16", DRYRUN_HILLCLIMB): "ok"}, \
        status
    ok = [r for r in recs if r["status"] == "ok"]
    log(format_table([r["roofline"] for r in ok]))
    log(f"(a) {len(argvs)} dry-run subprocesses in {wall:.1f} s (H100 "
        f"roofline: {PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16, "
        f"{HBM_BW / 1e12} TB/s, NVLink 450 GB/s each way)")
    return {"wall_s": wall, "cells": {
        f"{r['arch']} x {r['shape']} x {r['mesh']}"
        f"{' ' + r['tag'] if r.get('tag') else ''}":
        ({"roofline": r["roofline"], "host_s": r["compile_seconds"],
          "memory_analysis": r["memory_analysis"]}
         if r["status"] == "ok" else r["status"]) for r in recs}}


def _materialize(cell, vocab: int, gen):
    """Real tensors on the card for a cell's meta arguments: parameters
    N(0, 0.02²), token ids uniform over the vocabulary, caches, optimizer
    state and AdamW's step zero; decode's position the cache's last row,
    as the dry-run passes it."""
    from repro_torch.launch import dryrun, specs
    dev = torch.device("cuda")

    def param(t):
        return (torch.randn(t.shape, generator=gen, device=dev,
                            dtype=torch.float32) * 0.02).to(t.dtype)

    def other(t):
        if t.is_floating_point() or t.ndim == 0:
            return torch.zeros(t.shape, dtype=t.dtype, device=dev)
        return torch.randint(0, vocab, t.shape, generator=gen, device=dev,
                             dtype=t.dtype)
    args = (dryrun._map(param, cell.args[0]),) + tuple(
        dryrun._map(other, a) for a in cell.args[1:])
    if cell.kind == "decode":
        args = args[:-1] + (specs.SHAPES[cell.shape_name]["seq_len"] - 1,)
    return args


def _roofline_cell(shape: str, batch: int) -> dict:
    """One cell of olmo-1b at full width and depth on the card with
    ``global_batch`` cut to ``batch``: counted once by the dry-run's
    counters, then timed (median CUDA-event wall of ROOFLINE_STEPS steps
    after ROOFLINE_WARMUP) against the H100 roofline of its count."""
    from unittest import mock
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, specs
    cfg = get_config("olmo-1b")
    info = dict(specs.SHAPES[shape], global_batch=batch)
    with mock.patch.dict(specs.SHAPES, {shape: info}):
        cell = specs.build_cell(cfg, shape)
    gen = torch.Generator(device="cuda").manual_seed(13)
    args = _materialize(cell, cfg.vocab, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with dryrun.StepCounter() as counter:
        cell.step_fn(*args)
        torch.cuda.synchronize()
    walls = []
    for i in range(ROOFLINE_WARMUP + ROOFLINE_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        cell.step_fn(*args)
        end.record()
        end.synchronize()
        if i >= ROOFLINE_WARMUP:
            walls.append(start.elapsed_time(end))
    measured = statistics.median(walls)
    t_compute = counter.flops / PEAK_FLOPS * 1e3
    t_memory = counter.bytes / HBM_BW * 1e3
    bound = max(t_compute, t_memory)
    n_bytes = {"params": sum(t.numel() * t.element_size()
                             for t in dryrun._tensors(args[0])),
               "caches": sum(t.numel() * t.element_size()
                             for t in dryrun._tensors(args[2]))
               if cell.kind == "decode" else 0}
    out = {"shape": shape, "global_batch": batch,
           "global_batch_published": specs.SHAPES[shape]["global_batch"],
           "seq_len": info["seq_len"], "flops": counter.flops,
           "bytes": counter.bytes, "t_compute_ms": t_compute,
           "t_memory_ms": t_memory, "bound_ms": bound,
           "bound_by": "operations" if t_compute >= t_memory else "bytes",
           "measured_ms": measured, "walls_ms": walls,
           "bound_over_measured": bound / measured,
           "collectives": len(counter.records),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           **{f"{k}_bytes": v for k, v in n_bytes.items()}}
    del args, cell
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_roofline() -> dict:
    """Phase 13: (a) the dry-run's cells in subprocesses; (b) olmo-1b's
    decode_32k and train_4k on the card against the roofline of the
    dry-run's own count.  Launches none of K1-K3."""
    from repro_torch import kernels
    log("== phase 13: the dry-run (production meshes, fake process groups, "
        "subprocesses) and the roofline held against the card")
    wrappers = [getattr(kernels, name) for name in KERNELS]
    for fn in wrappers:
        fn.launches = fn.calls = 0
    gc.collect()
    torch.cuda.empty_cache()
    out = {"dryrun": _dryrun_cells()}
    log(f"(b) olmo-1b at full width and depth (16 layers, d 2048, 16 heads, "
        f"bf16) at world size 1; median CUDA-event wall of {ROOFLINE_STEPS} "
        f"steps after {ROOFLINE_WARMUP}")
    cells = [_roofline_cell("decode_32k", ROOFLINE_DECODE_BATCH)]
    for batch in ROOFLINE_TRAIN_BATCHES:
        try:
            cells.append(_roofline_cell("train_4k", batch))
            break
        except torch.cuda.OutOfMemoryError:
            log(f"  train_4k at global_batch {batch}: out of memory, cut "
                f"further")
        # the failed attempt's tensors die with the exception, here
        gc.collect()
        torch.cuda.empty_cache()
    else:
        raise AssertionError("train_4k fits at no global_batch of "
                             f"{ROOFLINE_TRAIN_BATCHES}")
    for c in cells:
        log(f"  {c['shape']}: global_batch cut {c['global_batch_published']}"
            f" -> {c['global_batch']} (seq {c['seq_len']}); counted "
            f"{c['flops']:.6e} FLOPs, {c['bytes']:.6e} bytes; t_compute "
            f"{c['t_compute_ms']:.4f} ms, t_memory {c['t_memory_ms']:.4f} "
            f"ms, bound {c['bound_ms']:.4f} ms ({c['bound_by']}); measured "
            f"{c['measured_ms']:.4f} ms (min {min(c['walls_ms']):.4f}, max "
            f"{max(c['walls_ms']):.4f}); bound / measured "
            f"{c['bound_over_measured']:.4f}; max memory allocated "
            f"{c['max_memory_allocated'] / 1e9:.2f} GB")
        assert c["measured_ms"] >= c["bound_ms"], \
            f"{c['shape']}: measured under the bound: the counters undercount"
        assert c["collectives"] == 0, c
    dec = cells[0]
    assert dec["bytes"] >= dec["params_bytes"] + dec["caches_bytes"], dec
    log(f"  decode counted bytes {dec['bytes']:.6e} >= parameters "
        f"{dec['params_bytes']:.6e} + caches {dec['caches_bytes']:.6e}")
    out["roofline"] = cells
    launched = {name: fn.launches for name, fn in zip(KERNELS, wrappers)}
    assert not any(launched.values()), launched
    log(f"K1-K3 launches in phase 13: {launched} (the dry-run and the model "
        f"stack run none)")
    return out


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


def _profile_steps(step, what: str) -> dict:
    """Where one step spends device time: the median of 5 unprofiled host
    walls of ``step`` (which returns after a copy to the host), then one
    step under ``torch.profiler``: device busy time, the device's idle
    share of the step's host wall, and the kernels by name.  Returns the
    median wall and the device busy time (None where the profiler saw no
    device time)."""
    from torch.profiler import ProfilerActivity, profile
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        walls.append((time.perf_counter() - t0) * 1e3)
    out = {"wall_ms": statistics.median(walls), "walls_ms": walls,
           "busy_ms": None}
    log(f"{what} host wall without the profiler: median of 5 "
        f"{statistics.median(walls):.2f} ms (min {min(walls):.2f}, max "
        f"{max(walls):.2f})")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        step()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, busy = {}, 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy += us
            by_name[e.name] = by_name.get(e.name, 0.0) + us
    if not by_name:
        log(f"{what} profile: the profiler recorded no device time "
            f"(device busy share not measured)")
        return out
    out["busy_ms"] = busy / 1e3
    out["idle_share"] = 1 - busy / wall_us
    out["top_items_ms"] = [
        (name[:90], us / 1e3)
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]]
    log(f"one {what} under the profiler: wall {wall_us / 1e3:.2f} ms, "
        f"device busy {busy / 1e3:.2f} ms, idle share "
        f"{1 - busy / wall_us:.3f}; against the unprofiled median wall "
        f"{1 - busy / 1e3 / statistics.median(walls):.3f}")
    for name, ms in out["top_items_ms"]:
        log(f"  {ms:9.3f} ms  {ms * 1e3 / busy:6.1%}  {name}")
    return out


def profile_tick(dec, pager=None) -> dict:
    """Where one batched decode tick (3 sequences) spends device time
    (:func:`_profile_steps`); given the engine's pager, also the bytes it
    loaded a tick over the 5 timed ticks."""
    rng = np.random.default_rng(3)
    last = [dec.prefill([int(t) for t in rng.integers(0, VOCAB, 32)], s)
            for s in range(3)]
    for _ in range(2):  # warm: view cache and allocator
        last = dec.decode([0, 1, 2], last)
    loaded = [pager.stats.bytes_loaded if pager is not None else 0]

    def tick():  # decode returns after the logits' copy to the host
        last[:] = dec.decode([0, 1, 2], last)
        if pager is not None:
            loaded.append(pager.stats.bytes_loaded)
    out = _profile_steps(tick, "decode tick (B=3, bucket 4)")
    if pager is not None:
        out["bytes_a_tick"] = (loaded[5] - loaded[0]) / 5
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
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
    serving, eng, fixed, tick5, served5 = timed("phase 5", phase_serving,
                                                N_LAYERS)
    prefix, _ = timed("phase 6", phase_prefix_serving, eng)
    cache_layout = eng.cache_layout
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    paged, paged_summary = timed("phase 7", phase_paged_serving, fixed)
    sharded, _ = timed("phase 8", phase_sharded_serving, fixed, tick5)
    http, http_summary = timed("phase 9", phase_http_serving, fixed, served5)
    direct_summary = timed("phase 10", phase_direct, fixed, served5, tick5,
                           paged_summary["h2d_bytes_per_s"])
    train_summary = timed("phase 11", phase_train)
    dist_summary = timed("phase 12", phase_distributed, train_summary)
    roofline_summary = timed("phase 13", phase_roofline)
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
        "sleep_timer": {**_sleep_timer(step),
                        "prefill_ms": prefill["kernel_sleep_ms"],
                        "prefill_library_ms": prefill["library_sleep_ms"]},
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
            "sleep_timer": _sleep_timer(r, N_LAYERS),
            "times_are": f"{what}'s {N_LAYERS} launches at {r['shape']}, "
                         f"{N_LAYERS} x the per-launch median"})
    r = attn_step["suffix"]
    kernels[-1]["suffix_prefill"] = {
        "shape": r["shape"], "plan": r["plan"],
        "ms": N_LAYERS * r["kernel_ms"], "plain_ms": N_LAYERS * r["plain_ms"],
        "library_ms": N_LAYERS * r["library_ms"],
        "bound_ms": N_LAYERS * r["bound_ms"], "bound_by": r["bound_by"],
        "sleep_timer": _sleep_timer(r, N_LAYERS),
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
        "sleep_timer": {
            **_sleep_timer(col),
            "decode_m4_ms": col_steps[4]["kernel_sleep_ms"],
            "prefill_ms": col_steps[PREFILL_M]["kernel_sleep_ms"]},
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
                "sleep_timer": _sleep_timer(r, N_LAYERS),
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
            "sleep_timer": {**_sleep_timer(r),
                            "prefill_ms": pre["kernel_sleep_ms"]},
            "times_are": f"one decode step's 225 sharded GEMMs at M=1, "
                         f"{n} launches a site on the strided slices the "
                         f"workers pass (contiguous_ms: on contiguous copies "
                         f"of the slices; prefill_*: M={PREFILL_M}), "
                         f"summed from shard 0's per-shape medians; library: "
                         f"torch.matmul on the same views"})
    log(f"phase 7 (paged): {json.dumps(paged_summary)}")
    log(f"phase 9 (HTTP): {json.dumps(http_summary)}")
    log(f"phase 10 (direct): {json.dumps(direct_summary)}")
    log(f"phase 11 (train): {json.dumps(train_summary)}")
    log(f"phase 12 (distributed): {json.dumps(dist_summary)}")
    log(f"phase 13 (dry-run, roofline): {json.dumps(roofline_summary)}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
