"""Hand-written Hopper kernels and their plain PyTorch versions (``ref``).

``chunked_matmul`` is the wrapper of the CUDA kernel; its ``calls`` and
``launches`` counters show whether a run went through it.
"""

from repro_torch.kernels.chunked_matmul import build as build_chunked_matmul
from repro_torch.kernels.chunked_matmul import chunked_matmul

__all__ = ["build_chunked_matmul", "chunked_matmul"]
