"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each function is the mathematical definition its hand-written kernel must
match: the CPU tests run these, and the GPU check holds each kernel
against its plain version on the same inputs.
"""

from __future__ import annotations

import torch


def chunked_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """C = X Wᵀ — the paper's MatMul-as-join+γ. x [M,K], w [N,K] → [M,N],
    accumulated in float32 and returned in ``x.dtype``."""
    return (x.float() @ w.float().T).to(x.dtype)
