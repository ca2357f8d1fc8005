"""Build and load the port's CUDA kernels: one helper for every ``.cu``.

Each kernel source under ``csrc/`` has a plain C interface.  At first use
it is compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``),
named by a hash of the source and the flags, and loaded with ``ctypes``.
``nvcc``'s ``-Xptxas -v`` report (registers, shared memory, spills) is
kept beside the library as ``.log``.  Nothing here runs when a module is
imported: the machines without ``nvcc`` import every module.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# built libraries go to build/kernels/ at the root of the checkout
BUILD_DIR = CSRC.parents[3] / "build" / "kernels"

_libs: Dict[str, ctypes.CDLL] = {}


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library built from this exact
    source and these flags is already there; returns the library's path.
    Raises with ``nvcc``'s output if the build fails."""
    source = CSRC / f"{name}.cu"
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}-{tag}.so"
    if out.exists():
        return out
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "nvcc"), *NVCC_FLAGS,
         "-o", str(tmp), str(source)],
        capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def library(name: str, argtypes: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built at first use), with
    ``argtypes`` set on each named C function; every one returns an
    ``int`` (the CUDA error code after its launch, 0 on success)."""
    if name not in _libs:
        lib = ctypes.CDLL(str(build(name)))
        for fn, types in argtypes.items():
            f = getattr(lib, fn)
            f.argtypes = list(types)
            f.restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]


def aligned16(*tensors) -> bool:
    """Whether 16-byte loads can read every row of each tensor: an aligned
    base pointer, and every stride but the inner one a multiple of 16
    bytes (a dimension of size 1 has no stride that is read).  The
    attention kernels take a scalar path where this is false."""
    for t in tensors:
        if t.data_ptr() % 16:
            return False
        size = t.element_size()
        for s, n in zip(t.stride()[:-1], t.shape[:-1]):
            if s * size % 16 and n != 1:
                return False
    return True


def on_device(device):
    """``torch.cuda.device(device)``, or nothing where ``device`` is already
    the current one (the usual case: a launch then costs no device switch
    on the host)."""
    import torch
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The streaming multiprocessors of a CUDA device (the kernels' plans
    size their grids to fill one wave of them)."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count
