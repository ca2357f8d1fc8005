"""Tests of the port that need a CUDA card (marker ``gpu``); they skip
without one.  This file imports neither JAX nor the JAX package, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The CUDA kernel is held against its plain version on the card (float32
within 1e-4: the sums run in another order than cuBLAS's; bfloat16 within
2e-2), and the engine on the card against the same engine on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.llama_graph import (LlamaSpec,  # noqa: E402
                                          init_llama_params)
from repro_torch.kernels import chunked_matmul, ref  # noqa: E402
from repro_torch.serving.engine import RelationalEngine  # noqa: E402

pytestmark = pytest.mark.gpu

SHAPES = [(32, 32, 32), (96, 64, 160), (17, 23, 40), (128, 128, 256),
          (1, 64, 160), (4, 23, 40), (16, 33, 300), (64, 1024, 4096)]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("m,n,k", SHAPES)
@pytest.mark.parametrize("dtype", list(TOL))
def test_kernel_matches_plain(cuda, m, n, k, dtype):
    rng = np.random.default_rng(m + n + k)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((n, k)) / np.sqrt(k)).astype(
        np.float32))
    x, w = x.to(cuda, dt), w.to(cuda, dt)
    launches = chunked_matmul.launches
    got = chunked_matmul(x, w)
    torch.cuda.synchronize()
    assert chunked_matmul.launches == launches + 1
    torch.testing.assert_close(got.float(), ref.chunked_matmul(x, w).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_kernel_takes_strided_rows(cuda):
    wide = torch.randn(6, 40, device=cuda)
    w = torch.randn(7, 24, device=cuda)
    x = wide[:, 8:32]
    torch.testing.assert_close(chunked_matmul(x, w), ref.chunked_matmul(x, w),
                               rtol=1e-4, atol=1e-4)


def test_mixed_devices_raise(cuda):
    with pytest.raises(ValueError):
        chunked_matmul(torch.ones(2, 4), torch.ones(3, 4, device=cuda))


def test_engine_on_the_card_matches_the_cpu(cuda):
    spec = LlamaSpec(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv=2,
                     d_ff=64, rope_theta=10000.0)
    params = init_llama_params(spec, seed=0)
    cpu = RelationalEngine(spec, params, chunk_size=8, max_len=32,
                           device="cpu")
    gpu = RelationalEngine(spec, params, chunk_size=8, max_len=32,
                           device=cuda)
    prompt = [3, 17, 42, 5]
    launches = chunked_matmul.launches
    np.testing.assert_allclose(gpu.start_session(prompt)["logits"],
                               cpu.start_session(prompt)["logits"],
                               rtol=1e-4, atol=1e-4)
    assert chunked_matmul.launches == launches + 7 * spec.n_layers + 1
    assert gpu.generate(prompt, 6).tokens == cpu.generate(prompt, 6).tokens
