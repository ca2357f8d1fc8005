"""``paged_attention``: decode attention over paged KV-cache tables on Hopper.

Replaces the TPU kernel ``src/repro/kernels/paged_attention.py``
(``paged_attention`` / ``_kernel``, reached through ``kernels/ops.py``):
one query token per sequence joined against that sequence's cached K/V
rows, found through a page table, with an online softmax over the pages.
The kernel is ``csrc/paged_attention.cu``, CUDA C++ for ``sm_90a`` with a
plain C interface, built and loaded by ``_build.py``.

One thread block per (sequence, KV head) walks the sequence's live pages
only: the work and the bytes read follow each sequence's length, and the
loop bound is read on the device, so no call waits on the host.  The
kernel is bound by the bytes of the live K/V rows.  At B = 4 with Llama-3-8B
widths only B·Hkv = 32 blocks run on the card's 132 SMs; split-K
flash-decoding (several blocks per sequence, combined in a second pass) is
the later design.

Semantics are the TPU kernel's: pages with a negative id and pages at or
past the length are skipped, slots at or past the length are masked, and a
sequence of length 0 gives zeros.  The plain version (``ref.paged_attention``,
the JAX oracle's) reads page 0 for an unmapped page and gives the mean of V
at length 0; the two agree whenever every page below the length is mapped
and the length is at least 1, as on the executor's path.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.  ``paged_attention.calls`` counts every call
and ``paged_attention.launches`` every kernel launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (8, 16, 32, 64, 128)  # the kernel's compiled head widths
MAX_GROUP = 16                    # query heads per KV head
_DTYPES = {torch.float32: "paged_attention_f32",
           torch.bfloat16: "paged_attention_bf16"}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 6 + [_I] * 6 + [_L] * 8 + [ctypes.c_float, _P]


def build():
    """Compile ``csrc/paged_attention.cu`` (see ``_build.build``); returns
    the shared library's path."""
    return _build.build("paged_attention")


def _library() -> ctypes.CDLL:
    return _build.library("paged_attention",
                          {fn: _ARGTYPES for fn in _DTYPES.values()})


def _is_index(t: torch.Tensor) -> bool:
    return not (t.is_floating_point() or t.is_complex()
                or t.dtype == torch.bool)


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
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"paged_attention takes float32 or bfloat16 q and "
                        f"pools of one dtype, got {q.dtype}, {k_pool.dtype} "
                        f"and {v_pool.dtype}")
    if not (_is_index(page_table) and _is_index(lengths)):
        raise TypeError(f"page_table and lengths must be integer tensors, "
                        f"got {page_table.dtype} and {lengths.dtype}")
    if not (q.device == k_pool.device == v_pool.device) \
            or q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"q on {q.device}, pools on {k_pool.device} and "
                         f"{v_pool.device}: all must lie on the CPU or on "
                         f"one CUDA device")
    for name, t in (("page_table", page_table), ("lengths", lengths)):
        if t.device not in (q.device, torch.device("cpu")):
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.stride(-1) != 1 and d > 1:
            raise ValueError(f"{name} needs unit inner stride, got strides "
                             f"{t.stride()}")


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
    if page_table.device.type == "cpu" and page_table.numel() \
            and int(page_table.max()) >= P:
        raise IndexError(f"page ids up to {int(page_table.max())} in a pool "
                         f"of {P} pages")
    pt = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, H, d), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    fn = getattr(_library(), _DTYPES[q.dtype])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 pt.data_ptr(), lens.data_ptr(), out.data_ptr(),
                 B, H, Hkv, d, page, pt.shape[1],
                 q.stride(0), q.stride(1),
                 *k_pool.stride()[:3], *v_pool.stride()[:3],
                 1.0 / d ** 0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error "
                           f"{err} (B={B}, H={H}, Hkv={Hkv}, d={d}, "
                           f"page={page}, {q.dtype})")
    paged_attention.launches += 1
    return out


paged_attention.calls = 0
paged_attention.launches = 0
