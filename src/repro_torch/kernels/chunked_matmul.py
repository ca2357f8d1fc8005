"""``chunked_matmul``: the chunked relational GEMM ``C = X·Wᵀ`` on Hopper,
in the weight table's row layout and in the planner's column layouts.

Replaces the TPU kernel ``src/repro/kernels/chunked_matmul.py``
(``chunked_matmul`` / ``_kernel``, reached through ``kernels/ops.py``'s
padding wrapper): the chunk-key equi-join of ``R_X(i, c, x_chunk)`` and
``R_W(j, c, w_chunk)`` plus ``γ_{(i,j)} SUM(dot)``.  The kernels are in
``csrc/chunked_matmul.cu``, CUDA C++ for ``sm_90a`` with a plain C
interface, built with ``nvcc`` at first use into the ``build/`` directory of
the checkout and loaded with ``ctypes`` (``_build.py``).

Two regimes, chosen per call by ``_plan`` (plain Python, so the CPU tests
cover every decision the CUDA side carries out):

- **decode** (M ≤ 16 rows): a weight-streaming GEMV, bound by the bytes of
  W.  Blocks of 16 W rows (one X row) or 32; K in four slabs (up to eight
  where X's slab would not fit in shared memory) that run as one
  thread-block cluster and add their partial sums through distributed
  shared memory.
- **prefill** (M > 16, or a decode whose X slab would not fit): a
  ``cp.async``-pipelined register-tiled GEMM, bound by the f32 FMA rate.
  Tiles of 64 (32 for M ≤ 32) × 128 outputs; K is split only to fill one
  wave of resident blocks on the card's SMs, into float32 partials in a
  workspace allocated here, which a second kernel adds.

Every split adds its partials in slab order, so a launch is deterministic.

**Column layouts** (``layout="col"``, the planner's ROW2COL tables).  A
COL_CHUNK table ``W__col(d, c, chunk[cs'])`` is W transposed: viewed as
``[K, N]`` with N contiguous, the join on ``d`` and ``γ SUM(x·chunk)``
grouped by the output chunk is ``C = X·W`` ("NN" where the row layout is
"NT").  A COL_CHUNK_HEADS table ``[H, K, dh/cs', cs']`` holds one such
``[K, dh]`` block per head: ``C[:, h, :] = X·W[h]``.  The kernels read the
blocks in place through a head stride (no transpose on the fly, which would
cost the bytes the layout saves), planned by ``_plan_col``:

- **decode** (M ≤ 16): a GEMV over the ``[K, N]`` operand.  A block owns
  one warp-width of columns (32 lanes × 4 contiguous elements) of one
  head; its 8 warps take interleaved rows of its K slab, each lane keeping
  the partial sums of its 4 columns for every X row, added across the
  warps in shared memory; K slabs run as one cluster and add through
  distributed shared memory, as in the row layout's GEMV.
- **prefill**: the tiled GEMM with its B tile loaded N-major
  (``[BK, 128]`` rows of contiguous columns) and each thread owning two
  runs of 4 columns, 32 apart, so that a warp's shared loads hit
  distinct banks.

On a CPU tensor the wrapper runs the plain version (``ref.chunked_matmul``);
on a CUDA tensor it launches the kernel or raises.  ``chunked_matmul.calls``
counts every call and ``chunked_matmul.launches`` every call that ran on
the card (one per call, whether or not K is split);
``chunked_matmul.col_launches`` counts those in the column layouts.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build, ref

_DTYPES = {torch.float32: "chunked_matmul_f32",
           torch.bfloat16: "chunked_matmul_bf16"}
_COL_DTYPES = {torch.float32: "chunked_matmul_col_f32",
               torch.bfloat16: "chunked_matmul_col_bf16"}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 4 + [_I] * 3 + [_L] * 3 + [_I] * 7 + [_P]
# x, w, out, ws, M, H, Nh, K, ldx, ldw, ldh, ldo, regime, tile, splits,
# kslab, vector, stream
_COL_ARGTYPES = [_P] * 4 + [_I] * 4 + [_L] * 4 + [_I] * 7 + [_P]
LAYOUTS = ("row", "col")
_REGIMES = {"decode": 0, "prefill": 1}

DECODE_MAX_M = 16          # rows the GEMV takes
# decode: 8 warps a block, 2 W rows a warp for one X row and 4 beyond
# (padded X rows -> W rows of a block); K in 4 slabs (a cluster of four,
# which packs into the card's GPCs), each at least 512 deep and at most
# 112 KB of X staged as f32, 8 slabs (one portable cluster) at most;
# slabs in steps of one warp's 16-byte f32 loads (32 lanes x 4)
GEMV_ROWS = {1: 16, 2: 32, 4: 32, 8: 32, 16: 32}
GEMV_SPLITS, GEMV_MAX_SPLITS, GEMV_MIN_SLAB = 4, 8, 512
GEMV_STEP, GEMV_SLAB_BYTES = 128, 112 << 10
# prefill: BM x 128 tiles, slabs at least 64 deep; two blocks resident per
# SM (registers bound it at BM = 64, shared memory at BM = 32)
GEMM_BN, GEMM_MIN_SLAB, GEMM_MAX_SPLITS, GEMM_RESIDENT = 128, 64, 32, 2
GEMM_BK = {64: 16, 32: 32}  # BM -> K depth of a shared-memory tile
# column-layout decode: a block owns 32 lanes x 4 contiguous columns (one
# column a lane on the scalar path); K slabs at least 256 deep, split until
# two waves of blocks cover the card
GEMV_COL_LANE_COLS, GEMV_COL_MIN_SLAB, GEMV_COL_WAVES = 4, 256, 2


class Plan(NamedTuple):
    """What the CUDA side runs for one call."""
    regime: str             # "decode" (GEMV) or "prefill" (tiled GEMM)
    tile: Tuple[int, int, int]  # (rows, columns, K step) of a block:
                                # decode (M padded to 1..16, W rows, 128),
                                # prefill (BM, 128, BK)
    splits: int             # K slabs on the grid's split axis
    workspace: int          # bytes of float32 partials (prefill split K)
    kslab: int              # K elements per slab (the last may be shorter)
    vec: int                # elements a load takes: 16 bytes' worth, or 1
    blocks: int             # thread blocks of the main kernel, splits included


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _cdiv(a, b) * b


def _pow2_ceil(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


@functools.lru_cache(maxsize=None)
def _plan(M: int, N: int, K: int, dtype: torch.dtype, aligned: bool,
          sms: int) -> Plan:
    """The tiling of one ``[M, K] x [N, K]ᵀ`` call on a card with ``sms``
    streaming multiprocessors.

    ``aligned`` lets the 16-byte vector path run: both pointers 16-byte
    aligned, and both row strides and K multiples of 16 bytes' worth of
    ``dtype``; otherwise the kernels load one element at a time."""
    if dtype not in _DTYPES:
        raise TypeError(f"chunked_matmul has no kernel for {dtype}")
    if M < 1 or N < 1 or K < 0:
        raise ValueError(f"no plan for M={M}, N={N}, K={K}")
    vec = 16 // dtype.itemsize if aligned else 1
    if M <= DECODE_MAX_M:
        mb = _pow2_ceil(M)  # the kernel's row count: 1..16
        rows = GEMV_ROWS[mb]
        # four slabs where K allows 512-deep ones; more (a power of two)
        # where X's slab would not fit in shared memory
        max_slab = GEMV_SLAB_BYTES // (4 * mb) // GEMV_STEP * GEMV_STEP
        want = max(min(GEMV_SPLITS, max(1, K // GEMV_MIN_SLAB)),
                   _pow2_ceil(_cdiv(K, max_slab)))
        if want <= GEMV_MAX_SPLITS:
            kslab = _round_up(_cdiv(max(K, 1), want), GEMV_STEP)
            splits = max(1, _cdiv(K, kslab))
            return Plan(regime="decode", tile=(mb, rows, GEMV_STEP),
                        splits=splits, workspace=0, kslab=kslab, vec=vec,
                        blocks=_cdiv(N, rows) * splits)
    bm = 32 if M <= 32 else 64
    bk = GEMM_BK[bm]
    tiles = _cdiv(N, GEMM_BN) * _cdiv(M, bm)
    # split K only to fill one wave of resident blocks: past it, more
    # blocks wait for a second wave and the partials cost bytes
    want = min(GEMM_MAX_SPLITS, GEMM_RESIDENT * sms // tiles,
               K // GEMM_MIN_SLAB)
    kslab = _round_up(_cdiv(max(K, 1), max(want, 1)), bk)
    splits = max(1, _cdiv(K, kslab))
    return Plan(regime="prefill", tile=(bm, GEMM_BN, bk), splits=splits,
                workspace=4 * splits * M * N if splits > 1 else 0,
                kslab=kslab, vec=vec, blocks=tiles * splits)


@functools.lru_cache(maxsize=None)
def _plan_col(M: int, H: int, Nh: int, K: int, dtype: torch.dtype,
              aligned: bool, sms: int) -> Plan:
    """The tiling of one column-layout call, ``X [M, K]`` times ``H``
    blocks ``[K, Nh]`` (``C [M, H·Nh]``), on a card with ``sms`` SMs.

    ``aligned``: both operands' pointers and strides (and K, Nh) are
    multiples of 16 bytes, so the vector paths run.  Decode tiles never
    cross a head: the grid has ``H · ceil(Nh / columns)`` column tiles."""
    if dtype not in _COL_DTYPES:
        raise TypeError(f"chunked_matmul has no kernel for {dtype}")
    if M < 1 or H < 1 or Nh < 1 or K < 0:
        raise ValueError(f"no plan for M={M}, H={H}, Nh={Nh}, K={K}")
    if M <= DECODE_MAX_M:
        mb = _pow2_ceil(M)
        lane_cols = GEMV_COL_LANE_COLS if aligned else 1
        cols = 32 * lane_cols
        tiles = H * _cdiv(Nh, cols)
        max_slab = GEMV_SLAB_BYTES // (4 * mb) // 32 * 32
        want = 1
        while (want < GEMV_MAX_SPLITS and tiles * want < GEMV_COL_WAVES * sms
               and K // (2 * want) >= GEMV_COL_MIN_SLAB):
            want *= 2
        want = max(want, _pow2_ceil(_cdiv(K, max_slab)))
        if want <= GEMV_MAX_SPLITS:
            kslab = _round_up(_cdiv(max(K, 1), want), 32)
            splits = max(1, _cdiv(K, kslab))
            return Plan(regime="decode", tile=(mb, cols, 8), splits=splits,
                        workspace=0, kslab=kslab, vec=lane_cols,
                        blocks=tiles * splits)
    bm = 32 if M <= 32 else 64
    bk = GEMM_BK[bm]
    tiles = H * _cdiv(Nh, GEMM_BN) * _cdiv(M, bm)
    want = min(GEMM_MAX_SPLITS, GEMM_RESIDENT * sms // tiles,
               K // GEMM_MIN_SLAB)
    kslab = _round_up(_cdiv(max(K, 1), max(want, 1)), bk)
    splits = max(1, _cdiv(K, kslab))
    return Plan(regime="prefill", tile=(bm, GEMM_BN, bk), splits=splits,
                workspace=4 * splits * M * H * Nh if splits > 1 else 0,
                kslab=kslab, vec=16 // dtype.itemsize if aligned else 1,
                blocks=tiles * splits)


def _aligned_col(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether the column kernels' 16-byte paths can read x [M, K] and
    w [H, K, Nh]: aligned pointers, x's rows as in ``_aligned``, and w's
    head and row strides and Nh multiples of 16 bytes."""
    vec = 16 // x.element_size()
    return (_aligned(x, x) and w.data_ptr() % 16 == 0
            and w.shape[2] % vec == 0
            and all(n == 1 or s % vec == 0
                    for s, n in zip(w.stride()[:2], w.shape[:2])))


def _aligned(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether the 16-byte vector path can read x and w (the row stride of
    a one-row operand is never read)."""
    vec = 16 // x.element_size()
    return (x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
            and x.shape[1] % vec == 0
            and all(t.shape[0] == 1 or t.stride(0) % vec == 0
                    for t in (x, w)))


def build():
    """Compile ``csrc/chunked_matmul.cu`` (see ``_build.build``); returns
    the shared library's path."""
    return _build.build("chunked_matmul")


def _library() -> ctypes.CDLL:
    return _build.library(
        "chunked_matmul", {**{fn: _ARGTYPES for fn in _DTYPES.values()},
                           **{fn: _COL_ARGTYPES
                              for fn in _COL_DTYPES.values()}})


def _check(x: torch.Tensor, w: torch.Tensor, layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if layout == "row" and (x.ndim != 2 or w.ndim != 2):
        raise ValueError(f"chunked_matmul takes 2-D x [M,K] and w [N,K], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if layout == "col" and (x.ndim != 2 or w.ndim != 3):
        raise ValueError(f"chunked_matmul(layout='col') takes 2-D x [M,K] "
                         f"and 3-D w [H,K,Nh], got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if x.shape[1] != w.shape[1]:
        raise ValueError(f"contraction widths differ: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)} ({layout} layout)")
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"chunked_matmul takes float32 or bfloat16 inputs "
                        f"of one dtype, got {x.dtype} and {w.dtype}")
    if x.device != w.device or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"x on {x.device} and w on {w.device}: both must "
                         f"lie on the CPU or on one CUDA device")
    for name, t in (("x", x), ("w", w)):
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"{name} needs unit inner stride, got strides "
                             f"{t.stride()}")


def chunked_matmul(x: torch.Tensor, w: torch.Tensor,
                   layout: str = "row") -> torch.Tensor:
    """The chunked GEMM in ``x.dtype``, summed in float32.

    ``layout="row"``: C = X Wᵀ, x [M, K], w [N, K] → [M, N].
    ``layout="col"``: w [H, K, Nh] holds H column blocks (a COL_CHUNK
    table is H = 1, a COL_CHUNK_HEADS table one block a head) and
    C [M, H·Nh] has ``C[:, h·Nh:(h+1)·Nh] = X · w[h]``.
    Any strides, but the inner one must be 1."""
    _check(x, w, layout)
    chunked_matmul.calls += 1
    if x.device.type == "cpu":
        return ref.chunked_matmul(x, w, layout)
    if layout == "col":
        return _launch_col(x, w)
    M, K = x.shape
    N = w.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    plan = _plan(M, N, K, x.dtype, _aligned(x, w),
                 _build.sm_count(x.device))
    ws = (torch.empty(plan.workspace // 4, dtype=torch.float32,
                      device=x.device) if plan.workspace else None)
    fn = getattr(_library(), _DTYPES[x.dtype])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                 ws.data_ptr() if ws is not None else None, M, N, K,
                 x.stride(0), w.stride(0), out.stride(0),
                 _REGIMES[plan.regime], *plan.tile, plan.splits, plan.kslab,
                 int(plan.vec > 1),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"chunked_matmul kernel launch failed: CUDA error "
                           f"{err} (M={M}, N={N}, K={K}, {x.dtype}, {plan})")
    chunked_matmul.launches += 1
    return out


def _launch_col(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    M, K = x.shape
    H, _, Nh = w.shape
    out = torch.empty((M, H * Nh), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    plan = _plan_col(M, H, Nh, K, x.dtype, _aligned_col(x, w),
                     _build.sm_count(x.device))
    ws = (torch.empty(plan.workspace // 4, dtype=torch.float32,
                      device=x.device) if plan.workspace else None)
    fn = getattr(_library(), _COL_DTYPES[x.dtype])
    with _build.on_device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                 ws.data_ptr() if ws is not None else None, M, H, Nh, K,
                 x.stride(0), w.stride(1), w.stride(0), out.stride(0),
                 _REGIMES[plan.regime], *plan.tile, plan.splits, plan.kslab,
                 int(plan.vec > 1),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"chunked_matmul (col) kernel launch failed: CUDA "
                           f"error {err} (M={M}, H={H}, Nh={Nh}, K={K}, "
                           f"{x.dtype}, {plan})")
    chunked_matmul.launches += 1
    chunked_matmul.col_launches += 1
    return out


chunked_matmul.calls = 0
chunked_matmul.col_launches = 0
chunked_matmul.launches = 0
