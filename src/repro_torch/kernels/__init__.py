"""Hand-written Hopper kernels and their plain PyTorch versions (``ref``).

``chunked_matmul``, ``paged_attention`` and ``flash_attention`` are the
wrappers of the CUDA kernels; each one's ``calls`` and ``launches``
counters show whether a run went through it.  ``build_*`` compiles a
kernel's source ahead of its first call.
"""

from repro_torch.kernels.chunked_matmul import build as build_chunked_matmul
from repro_torch.kernels.chunked_matmul import chunked_matmul
from repro_torch.kernels.flash_attention import build as build_flash_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import build as build_paged_attention
from repro_torch.kernels.paged_attention import paged_attention

__all__ = ["build_chunked_matmul", "build_flash_attention",
           "build_paged_attention", "chunked_matmul", "flash_attention",
           "paged_attention"]
