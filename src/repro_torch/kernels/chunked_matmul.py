"""``chunked_matmul``: the chunked relational GEMM ``C = X·Wᵀ`` on Hopper.

Replaces the TPU kernel ``src/repro/kernels/chunked_matmul.py``
(``chunked_matmul`` / ``_kernel``, reached through ``kernels/ops.py``'s
padding wrapper): the chunk-key equi-join of ``R_X(i, c, x_chunk)`` and
``R_W(j, c, w_chunk)`` plus ``γ_{(i,j)} SUM(dot)``.  The kernel is
``csrc/chunked_matmul.cu``, CUDA C++ for ``sm_90a`` with a plain C
interface, built with ``nvcc`` at first use into the ``build/`` directory of
the checkout and loaded with ``ctypes`` (``_build.py``).

At decode shapes (M = 1..4 rows) the product is bound by the bytes of W:
each W element is read once for about two flops.  The kernel's small-M
tiling keeps all decode rows in one block row, so W crosses from device
memory exactly once, in coalesced K-contiguous loads of 128-deep tiles
whose next tile is fetched while the current one is summed (see the .cu
source for the tilings).

On a CPU tensor the wrapper runs the plain version (``ref.chunked_matmul``);
on a CUDA tensor it launches the kernel or raises.  ``chunked_matmul.calls``
counts every call and ``chunked_matmul.launches`` every kernel launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_DTYPES = {torch.float32: "chunked_matmul_f32",
           torch.bfloat16: "chunked_matmul_bf16"}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_void_p]


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
    fn = getattr(_library(), _DTYPES[x.dtype])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K,
                 x.stride(0), w.stride(0), out.stride(0),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"chunked_matmul kernel launch failed: CUDA error "
                           f"{err} (M={M}, N={N}, K={K}, {x.dtype})")
    chunked_matmul.launches += 1
    return out


chunked_matmul.calls = 0
chunked_matmul.launches = 0
