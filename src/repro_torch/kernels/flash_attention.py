"""``flash_attention``: causal prefill attention on Hopper.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention`` / ``_kernel``, reached through ``kernels/ops.py``):
the score join, the softmax's row aggregations and the V join in one pass
with an online softmax, so the T×S score relation never materialises.  The
kernel is ``csrc/flash_attention.cu``, CUDA C++ for ``sm_90a`` with a plain
C interface, built and loaded by ``_build.py``.

One thread block per (b·h, 32-row query tile) loops over 32-row KV tiles
and skips those above the causal diagonal.  The causal mask is top-left
aligned (query t sees keys s ≤ t), so T < S is legal; ragged T and S are
masked in the kernel (the TPU version asserts T % bq = S % bk = 0).  K/V may
have fewer heads than q (query head h reads KV head h // (H/Hkv)), and
every operand is passed with its (b, h, t) strides, so permuted views need
no copy.  At prefill lengths the kernel is bound by the f32 rate of the
CUDA cores (see the .cu source).

On a CPU tensor the wrapper runs the plain version (``ref.flash_attention``);
on a CUDA tensor it launches the kernel or raises.
``flash_attention.calls`` counts every call and ``flash_attention.launches``
every kernel launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (8, 16, 32, 64, 128)  # the kernel's compiled head widths
_DTYPES = {torch.float32: "flash_attention_f32",
           torch.bfloat16: "flash_attention_bf16"}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 7 + [_P, ctypes.c_float, _P]


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
                    causal: bool = True) -> torch.Tensor:
    """Attention of q [B,H,T,d] over k/v [B,Hkv,S,d] → [B,H,T,d] in
    ``q.dtype``, scale 1/√d, causal mask top-left aligned.  Operands may
    have any (b, h, t) strides with a unit inner stride; the output has
    q's layout."""
    _check(q, k, v)
    flash_attention.calls += 1
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal)
    B, H, T, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS or B * H > 65535:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS} and at most "
                         f"65535 (batch, head) pairs, got d={d}, B={B}, H={H}")
    out = torch.empty_like(q)  # q's layout where q is dense, else contiguous
    if B * H * T == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in t.stride()[:3]))
    fn = getattr(_library(), _DTYPES[q.dtype])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, H, Hkv, T, S, d, int(causal), strides, 1.0 / d ** 0.5,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err} (B={B}, H={H}, Hkv={Hkv}, T={T}, S={S}, "
                           f"d={d}, {q.dtype})")
    flash_attention.launches += 1
    return out


flash_attention.calls = 0
flash_attention.launches = 0
