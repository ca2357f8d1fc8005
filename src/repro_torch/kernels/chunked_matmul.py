"""``chunked_matmul``: the chunked relational GEMM ``C = X·Wᵀ`` on Hopper.

Replaces the TPU kernel ``src/repro/kernels/chunked_matmul.py``
(``chunked_matmul`` / ``_kernel``, reached through ``kernels/ops.py``'s
padding wrapper): the chunk-key equi-join of ``R_X(i, c, x_chunk)`` and
``R_W(j, c, w_chunk)`` plus ``γ_{(i,j)} SUM(dot)``.  The kernel is
``csrc/chunked_matmul.cu``, CUDA C++ for ``sm_90a`` with a plain C
interface, built with ``nvcc`` at first use into the ``build/`` directory of
the checkout and loaded with ``ctypes``.

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
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "chunked_matmul.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_DTYPES = {torch.float32: "chunked_matmul_f32",
           torch.bfloat16: "chunked_matmul_bf16"}

# built libraries go to build/kernels/ at the root of the checkout
# (listed in .gitignore)
BUILD_DIR = SOURCE.parents[4] / "build" / "kernels"

_lib: Optional[ctypes.CDLL] = None


def build() -> Path:
    """Compile ``csrc/chunked_matmul.cu`` with ``nvcc`` for ``sm_90a`` unless
    a library built from this exact source is already there; returns the
    shared library's path.  ``nvcc``'s ``-Xptxas -v`` report (registers,
    shared memory, spills) is kept beside it as ``.log``."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libchunked_matmul-{tag}.so"
    if out.exists():
        return out
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "nvcc"), *NVCC_FLAGS,
         "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for fn in _DTYPES.values():
            f = getattr(lib, fn)
            f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_longlong, ctypes.c_longlong,
                          ctypes.c_longlong, ctypes.c_void_p]
            f.restype = ctypes.c_int
        _lib = lib
    return _lib


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
