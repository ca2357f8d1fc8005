"""``paged_attention``: decode attention over paged KV-cache tables on Hopper.

Replaces the TPU kernel ``src/repro/kernels/paged_attention.py``
(``paged_attention`` / ``_kernel``, reached through ``kernels/ops.py``):
one query token per sequence joined against that sequence's cached K/V
rows, found through a page table, with an online softmax over the pages.
The kernel is ``csrc/paged_attention.cu``, CUDA C++ for ``sm_90a`` with a
plain C interface, built and loaded by ``_build.py``.

Split-K flash-decoding.  One block per (sequence, KV head) walking its
pages in order, as the TPU kernel's grid does, leaves 100 of 132 SMs idle
at B = 4 with Llama-3-8B widths, and sets a launch's time by one block's
serial walk.  Here each (sequence, KV head) is split over ``n_split``
blocks, chosen by ``_plan`` (plain Python, so the CPU tests cover it) for
about two waves of blocks on the card's SMs.  Each block reads its
sequence's length on the device and takes the slots
``[s·c, min((s+1)·c, len))`` with ``c = ceil(len / n_split)`` rounded up
to a multiple of ``c_min``, so no call waits on the host and a short sequence
spreads over fewer blocks than a long one.  The splits of a (sequence, KV
head) form one thread-block cluster, and their (max, sum, accumulator)
states are merged in split order through distributed shared memory, so a
launch is deterministic.  The kernel is bound by the bytes of the live K/V
rows; what the design fights is latency (see the .cu note).

Semantics are the TPU kernel's: pages with a negative id and pages at or
past the length are skipped, slots at or past the length are masked, and a
sequence of length 0 gives zeros.  The plain version (``ref.paged_attention``,
the JAX oracle's) reads page 0 for an unmapped page and gives the mean of V
at length 0; the two agree whenever every page below the length is mapped
and the length is at least 1, as on the executor's path.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.  ``paged_attention.calls`` counts every call
and ``paged_attention.launches`` every call that ran on the card (one
launch a call).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (8, 16, 32, 64, 128)  # the kernel's compiled head widths
MAX_GROUP = 16                    # query heads per KV head
_DTYPES = {torch.float32: "paged_attention_f32",
           torch.bfloat16: "paged_attention_bf16"}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 6 + [_I] * 9 + [_L] * 8 + [ctypes.c_float, _P]

SPLIT_TILE = 16    # c_min: a split's slots, a multiple of this
WAVES = 2          # blocks the plan aims at, in waves of the card's SMs
CLUSTER_MAX = 16   # splits merged in one (non-portable) thread-block cluster


class Plan(NamedTuple):
    """What the CUDA side runs for one call."""
    n_split: int   # blocks per (sequence, KV head), one cluster: grid
                   # (Hkv, B, n_split)
    c_min: int     # a split takes a multiple of c_min slots (the last
                   # non-empty one the rest)
    blocks: int    # thread blocks of the launch


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2_floor(n: int) -> int:
    return 1 << (max(n, 1).bit_length() - 1)


@functools.lru_cache(maxsize=None)
def _plan(B: int, Hkv: int, max_pages: int, page: int, d: int,
          dtype: torch.dtype, sms: int) -> Plan:
    """The split of one call over B sequences of at most
    ``max_pages · page`` slots on a card with ``sms`` SMs.

    The launch lasts as long as its longest split, so the plan aims at
    ``WAVES`` waves of blocks (a power of two splits a (sequence, KV
    head)), no more splits than the capacity has ``SPLIT_TILE``s, and at
    most one cluster of ``CLUSTER_MAX``: on the card, 16 splits merged in a
    cluster at B = 1, len 512 beat 16 or 17 merged by a second launch
    over a workspace (PERF.md).  The lengths are not read (they
    stay on the device); a block whose range is empty writes the empty
    state (max −∞, sum 0)."""
    if dtype not in _DTYPES:
        raise TypeError(f"paged_attention has no kernel for {dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {d}")
    if B < 1 or Hkv < 1 or max_pages < 0 or page < 1:
        raise ValueError(f"no plan for B={B}, Hkv={Hkv}, "
                         f"max_pages={max_pages}, page={page}")
    n_split = max(1, min(_pow2_floor(WAVES * sms // (B * Hkv)),
                         _cdiv(max_pages * page, SPLIT_TILE), CLUSTER_MAX))
    return Plan(n_split=n_split, c_min=SPLIT_TILE, blocks=B * Hkv * n_split)


def build():
    """Compile ``csrc/paged_attention.cu`` (see ``_build.build``); returns
    the shared library's path."""
    return _build.build("paged_attention")


def _library() -> ctypes.CDLL:
    return _build.library("paged_attention",
                          {fn: _ARGTYPES for fn in _DTYPES.values()})


# integer dtypes a page table or lengths may have (not float, complex or
# bool)
_INDEX_DTYPES = frozenset(
    t for t in vars(torch).values() if isinstance(t, torch.dtype)
    and not (t.is_floating_point or t.is_complex or t == torch.bool))


def _check(q, k_pool, v_pool, page_table, lengths) -> None:
    if q.ndim != 3 or k_pool.ndim != 4 or page_table.ndim != 2 \
            or lengths.ndim != 1:
        raise ValueError(
            f"paged_attention takes q [B,H,d], pools [P,page,Hkv,d], "
            f"page_table [B,max_pages] and lengths [B], got "
            f"{tuple(q.shape)}, {tuple(k_pool.shape)}, "
            f"{tuple(page_table.shape)} and {tuple(lengths.shape)}")
    B, H, d = q.shape
    if v_pool.shape != k_pool.shape or k_pool.shape[3] != d \
            or page_table.shape[0] != B or lengths.shape[0] != B:
        raise ValueError(
            f"shapes disagree: q {tuple(q.shape)}, k_pool "
            f"{tuple(k_pool.shape)}, v_pool {tuple(v_pool.shape)}, "
            f"page_table {tuple(page_table.shape)}, lengths "
            f"{tuple(lengths.shape)}")
    Hkv = k_pool.shape[2]
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} KV heads")
    dtype = q.dtype
    if dtype not in _DTYPES or k_pool.dtype != dtype \
            or v_pool.dtype != dtype:
        raise TypeError(f"paged_attention takes float32 or bfloat16 q and "
                        f"pools of one dtype, got {dtype}, {k_pool.dtype} "
                        f"and {v_pool.dtype}")
    if page_table.dtype not in _INDEX_DTYPES \
            or lengths.dtype not in _INDEX_DTYPES:
        raise TypeError(f"page_table and lengths must be integer tensors, "
                        f"got {page_table.dtype} and {lengths.dtype}")
    dev = q.device
    if dev.type not in ("cpu", "cuda") or k_pool.device != dev \
            or v_pool.device != dev:
        raise ValueError(f"q on {dev}, pools on {k_pool.device} and "
                         f"{v_pool.device}: all must lie on the CPU or on "
                         f"one CUDA device")
    for name, t in (("page_table", page_table), ("lengths", lengths)):
        td = t.device
        if td != dev and td.type != "cpu":
            raise ValueError(f"{name} on {td}, q on {dev}")
    if d > 1:
        for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
            if t.stride(-1) != 1:
                raise ValueError(f"{name} needs unit inner stride, got "
                                 f"strides {t.stride()}")


def _launch(q, k_pool, v_pool, pt, lens, plan: Plan) -> torch.Tensor:
    """Run ``plan`` on the card: q [B,H,d], the pools, an int32 page table
    and int32 lengths on q's device → [B,H,d].  Counts nothing."""
    B, H, d = q.shape
    P, page, Hkv, _ = k_pool.shape
    out = torch.empty((B, H, d), dtype=q.dtype, device=q.device)
    fn = getattr(_library(), _DTYPES[q.dtype])
    with _build.on_device(q.device):
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 pt.data_ptr(), lens.data_ptr(), out.data_ptr(),
                 B, H, Hkv, d, page, pt.shape[1], plan.n_split, plan.c_min,
                 int(_build.aligned16(k_pool, v_pool)),
                 q.stride(0), q.stride(1),
                 *k_pool.stride()[:3], *v_pool.stride()[:3],
                 1.0 / d ** 0.5, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error "
                           f"{err} (B={B}, H={H}, Hkv={Hkv}, d={d}, "
                           f"page={page}, {q.dtype}, {plan})")
    return out


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention: q [B,H,d] over pools [P,page,Hkv,d] through
    page_table [B,max_pages] (-1 unmapped) with lengths [B] → [B,H,d] in
    ``q.dtype``, scale 1/√d, query head h reading KV head h // (H/Hkv).

    The pools may have any strides with a unit inner stride.  The page
    table and lengths may be of any integer type, on the CPU or on q's
    device; they are converted to int32 on the device here.  Page ids are
    not checked on the device (that would need a sync): the caller keeps
    them below P."""
    _check(q, k_pool, v_pool, page_table, lengths)
    paged_attention.calls += 1
    if q.device.type == "cpu":
        return ref.paged_attention(q, k_pool, v_pool, page_table, lengths)
    B, H, d = q.shape
    P, page, Hkv, _ = k_pool.shape
    if d not in HEAD_DIMS or H // Hkv > MAX_GROUP:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS} and at most "
                         f"{MAX_GROUP} query heads per KV head, got d={d}, "
                         f"H={H}, Hkv={Hkv}")
    if B > 65535:
        raise ValueError(f"the kernel takes at most 65535 sequences, got {B}")
    if page_table.device.type == "cpu" and page_table.numel() \
            and int(page_table.max()) >= P:
        raise IndexError(f"page ids up to {int(page_table.max())} in a pool "
                         f"of {P} pages")
    if B == 0:
        return torch.empty((0, H, d), dtype=q.dtype, device=q.device)
    pt = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    plan = _plan(B, Hkv, pt.shape[1], page, d, q.dtype,
                 _build.sm_count(q.device))
    out = _launch(q, k_pool, v_pool, pt, lens, plan)
    paged_attention.launches += 1
    return out


paged_attention.calls = 0
paged_attention.launches = 0
