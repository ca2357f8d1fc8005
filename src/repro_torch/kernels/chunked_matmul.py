"""``chunked_matmul``: the chunked relational GEMM ``C = X·Wᵀ`` on Hopper.

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

On a CPU tensor the wrapper runs the plain version (``ref.chunked_matmul``);
on a CUDA tensor it launches the kernel or raises.  ``chunked_matmul.calls``
counts every call and ``chunked_matmul.launches`` every call that ran on
the card (one per call, whether or not K is split).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build, ref

_DTYPES = {torch.float32: "chunked_matmul_f32",
           torch.bfloat16: "chunked_matmul_bf16"}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
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
    return _build.library("chunked_matmul",
                          {fn: _ARGTYPES for fn in _DTYPES.values()})


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"chunked_matmul takes 2-D x [M,K] and w [N,K], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.shape[1] != w.shape[1]:
        raise ValueError(f"contraction widths differ: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"chunked_matmul takes float32 or bfloat16 inputs "
                        f"of one dtype, got {x.dtype} and {w.dtype}")
    if x.device != w.device or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"x on {x.device} and w on {w.device}: both must "
                         f"lie on the CPU or on one CUDA device")
    for name, t in (("x", x), ("w", w)):
        if t.stride(1) != 1 and t.shape[1] > 1:
            raise ValueError(f"{name} needs unit inner stride, got strides "
                             f"{t.stride()}")


def chunked_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """C = X Wᵀ over chunked tables: x [M, K], w [N, K] → [M, N] in
    ``x.dtype``, summed in float32.  Rows may have any stride; the inner
    (K) stride must be 1."""
    _check(x, w)
    chunked_matmul.calls += 1
    if x.device.type == "cpu":
        return ref.chunked_matmul(x, w)
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


chunked_matmul.calls = 0
chunked_matmul.launches = 0
