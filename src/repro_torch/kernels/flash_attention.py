"""``flash_attention``: causal prefill attention on Hopper.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention`` / ``_kernel``, reached through ``kernels/ops.py``):
the score join, the softmax's row aggregations and the V join in one pass
with an online softmax, so the T×S score relation never materialises.  The
kernel is ``csrc/flash_attention.cu``, CUDA C++ for ``sm_90a`` with a plain
C interface, built and loaded by ``_build.py``.

On the tensor cores.  ``_plan`` (plain Python, so the CPU tests cover
it) picks a block of four warps, each warp owning 16 query rows of one
head: ``gcd(4, g)`` of them on the g query heads that read one KV head
(one staged K/V tile serves them all) and the rest on consecutive query
tiles, halved only while a block would hold query tiles past T.  At T =
32 and 64 (one or two query tiles a head) that keeps four warps on four
query heads, 16 and 32 blocks at Llama-3-8B widths: a launch there is set
by one block's latency, and four warps stage a K/V tile with four times
the threads of one.  K/V tiles of 32 (f32) or 64 (bf16) rows arrive by
``cp.async`` into a double buffer; Q·Kᵀ and P·V run as ``mma.sync``: f32
as 3×TF32 (each operand split into two TF32 halves, three products, so
the result keeps about f32 accuracy), bf16 with f32 accumulation.  The
causal mask places query row t at position ``t + q_offset`` (it sees keys
s ≤ t + q_offset): at 0 top-left aligned, so T < S is legal (a prefill
over a cache_len-deep cache); a suffix prefill of the prefix cache passes
the cached prefix's length, a host int like every runtime scalar of the
port, so the launch needs no device scalar and no sync.  Tiles above the
diagonal are never loaded, and ragged T and S are masked in the kernel
(the TPU version asserts T % bq = S % bk = 0 and has no offset).  A
launch with an offset runs a second build of the kernel
(``csrc/flash_attention.cu``, ``kOffset``), so that cold prefills keep the
code built without one.  K/V may have fewer heads than q (query head h
reads KV head h // (H/Hkv)), and every operand is passed with its (b, h,
t) strides, so permuted views need no copy.

On a CPU tensor the wrapper runs the plain version (``ref.flash_attention``);
on a CUDA tensor it launches the kernel or raises.
``flash_attention.calls`` counts every call and ``flash_attention.launches``
every kernel launch.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (8, 16, 32, 64, 128)  # the kernel's compiled head widths
_DTYPES = {torch.float32: "flash_attention_f32",
           torch.bfloat16: "flash_attention_bf16"}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 13 + [_P, ctypes.c_float, _P]

WARP_ROWS = 16         # query rows of one warp: the mma tile's M
MAX_WARPS = 4
KV_ROWS = {torch.float32: 32, torch.bfloat16: 64}  # K/V rows of a tile
_KSTEP = {torch.float32: 8, torch.bfloat16: 16}    # the mma's K depth


class Plan(NamedTuple):
    """What the CUDA side runs for one call."""
    warps: int     # warps of a block
    heads: int     # query heads of a block, all reading one KV head
    rows: int      # query rows of a block (of each of its heads)
    balance: bool  # each block takes two groups of rows, the x-th latest
                   # and the x-th earliest (equal causal work a block)
    bk: int        # K/V rows of a staged tile
    blocks: int    # thread blocks of the launch
    smem: int      # bytes of dynamic shared memory a block takes


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _tile_strides(d: int, dtype: torch.dtype):
    """Row strides (elements) of the staged K and V tiles: padded so that
    the mma fragments' shared-memory reads fall in distinct banks, rows
    16-byte aligned for ``cp.async``.  K's rows are zero-padded to the
    mma's K depth (d = 8 in bf16)."""
    dk = _cdiv(d, _KSTEP[dtype]) * _KSTEP[dtype]
    if dtype == torch.float32:
        return (24 if dk == 8 else dk + 8), d + 4
    return dk + 8, d + 8


@functools.lru_cache(maxsize=None)
def _plan(B: int, T: int, S: int, H: int, Hkv: int, d: int,
          dtype: torch.dtype, sms: int) -> Plan:
    """The tiling of one call on a card with ``sms`` SMs.

    Four warps a block, ``gcd(4, g)`` of them on the g query heads of one
    KV head (one staged K/V tile serves them) and the rest on consecutive
    query tiles, halved while a block would hold query tiles past T.  At
    the main path's prompts a launch is set by one block's latency (Q and
    the first K/V tile from memory, then one or two tiles of products), and
    four warps load a tile with four times the threads of one.  Where the
    grid would hold more blocks than the card's ``sms`` SMs, so that SMs
    run several blocks each, each block takes two row groups, the x-th
    latest and the x-th earliest, so that causal blocks hold equal work
    and no SM gets two of the longest.

    The plan does not depend on the causal offset of a suffix prefill:
    row group i reads about ``q_offset + (i + 1)·rows`` keys, so a pair
    of groups reads the same sum at every offset (the offset only adds
    the same prefix to every group), and a large offset makes the groups
    nearly equal, where pairing costs nothing."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention has no kernel for {dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {d}")
    if B < 1 or T < 1 or S < 0 or Hkv < 1 or H % Hkv:
        raise ValueError(f"no plan for B={B}, T={T}, S={S}, H={H}, "
                         f"Hkv={Hkv}")
    g = H // Hkv
    warps = MAX_WARPS
    while warps > 1 and warps // math.gcd(warps, g) > _cdiv(T, WARP_ROWS):
        warps //= 2
    heads = math.gcd(warps, g)
    rows = WARP_ROWS * warps // heads
    nqb = _cdiv(T, rows)
    blocks = B * (H // heads) * nqb
    balance = blocks > sms and nqb > 1
    if balance:
        blocks = B * (H // heads) * _cdiv(nqb, 2)
    bk = KV_ROWS[dtype]
    ldk, ldv = _tile_strides(d, dtype)
    q_rows = warps * WARP_ROWS * ldk if dtype == torch.float32 else 0
    return Plan(warps=warps, heads=heads, rows=rows, balance=balance,
                bk=bk, blocks=blocks,
                smem=(2 * bk * (ldk + ldv) + q_rows) * dtype.itemsize)


def build():
    """Compile ``csrc/flash_attention.cu`` (see ``_build.build``); returns
    the shared library's path."""
    return _build.build("flash_attention")


def _library() -> ctypes.CDLL:
    return _build.library("flash_attention",
                          {fn: _ARGTYPES for fn in _DTYPES.values()})


def _check(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"flash_attention takes q [B,H,T,d] and k/v "
                         f"[B,Hkv,S,d], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    B, H, _, d = q.shape
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    Hkv = k.shape[1]
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} KV heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype} and "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device) \
            or q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on "
                         f"{v.device}: all must lie on the CPU or on one "
                         f"CUDA device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 and d > 1:
            raise ValueError(f"{name} needs unit inner stride, got strides "
                             f"{t.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Attention of q [B,H,T,d] over k/v [B,Hkv,S,d] → [B,H,T,d] in
    ``q.dtype``, scale 1/√d; with ``causal`` query row t sees keys
    s ≤ t + ``q_offset`` (0 ≤ q_offset, q_offset + T ≤ S).  Operands may
    have any (b, h, t) strides with a unit inner stride; the output has
    q's layout."""
    _check(q, k, v)
    B, H, T, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    q_offset = int(q_offset)
    if q_offset < 0 or q_offset + T > S:
        raise ValueError(f"query rows at positions [{q_offset}, "
                         f"{q_offset + T}) lie outside the {S} keys")
    flash_attention.calls += 1
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal, q_offset=q_offset)
    if d not in HEAD_DIMS or B * H > 65535:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS} and at most "
                         f"65535 (batch, head) pairs, got d={d}, B={B}, H={H}")
    out = torch.empty_like(q)  # q's layout where q is dense, else contiguous
    if B * H * T == 0:
        return out
    plan = _plan(B, T, S, H, Hkv, d, q.dtype, _build.sm_count(q.device))
    _launch(q, k, v, out, causal, q_offset, plan)
    flash_attention.launches += 1
    return out


def _launch(q, k, v, out, causal: bool, q_offset: int, plan: Plan) -> None:
    """Run ``plan`` on the card, writing ``out``.  Counts nothing."""
    B, H, T, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in t.stride()[:3]))
    fn = getattr(_library(), _DTYPES[q.dtype])
    with _build.on_device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, H, Hkv, T, S, d, int(causal), q_offset, plan.warps,
                 plan.heads, int(plan.balance), plan.bk,
                 int(_build.aligned16(k, v)),
                 strides, 1.0 / d ** 0.5,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err} (B={B}, H={H}, Hkv={Hkv}, T={T}, S={S}, "
                           f"d={d}, q_offset={q_offset}, {q.dtype}, {plan})")


flash_attention.calls = 0
flash_attention.launches = 0
