"""The port's ``chunked_matmul`` against the JAX package's Pallas kernel.

On the CPU the wrapper runs its plain version; it is held against the
Pallas kernel in interpret mode and the JAX oracle at the sweeps of
``tests/test_kernels.py``.  Tolerances are those of that file: 2e-5 in
float32, 2e-2 in bfloat16.  The CUDA kernel itself is held against the
plain version in ``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro_torch.kernels import chunked_matmul, ref  # noqa: E402

SHAPES = [(32, 32, 32), (96, 64, 160), (17, 23, 40), (128, 128, 256),
          (1, 64, 160), (4, 23, 40)]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(m, n, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((n, k)).astype(np.float32))


@pytest.mark.parametrize("m,n,k", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_pallas_kernel(m, n, k, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x, w = _inputs(m, n, k, seed=m * 1000 + n + k)
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    want_kernel = jops.chunked_matmul(jx, jw, bm=32, bn=32, bk=32,
                                      interpret=True)
    want_ref = jref.chunked_matmul(jx, jw)
    got = chunked_matmul(torch.from_numpy(x).to(tdt),
                         torch.from_numpy(w).to(tdt))
    assert got.dtype == tdt and got.shape == (m, n)
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("bk", [16, 32, 64])
def test_chunk_size_never_changes_result(bk):
    """The relational chunk size is the Pallas kernel's bk; the port's
    result must equal the kernel's at every one of them."""
    x, w = _inputs(64, 48, 128, seed=bk)
    want = jops.chunked_matmul(jnp.asarray(x), jnp.asarray(w), bm=32,
                               bn=16, bk=bk, interpret=True)
    got = chunked_matmul(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_cpu_tensors_take_the_plain_version():
    x, w = _inputs(3, 5, 8, seed=0)
    calls, launches = chunked_matmul.calls, chunked_matmul.launches
    got = chunked_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert chunked_matmul.calls == calls + 1
    assert chunked_matmul.launches == launches
    assert torch.equal(got, ref.chunked_matmul(torch.from_numpy(x),
                                               torch.from_numpy(w)))


def test_row_strides_need_no_copy():
    """Rows of a wider tensor (row stride > K) are taken as they are."""
    rng = np.random.default_rng(1)
    wide = torch.from_numpy(rng.standard_normal((6, 40)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((7, 24)).astype(np.float32))
    x = wide[:, 8:32]
    assert x.stride() == (40, 1)
    np.testing.assert_allclose(chunked_matmul(x, w).numpy(),
                               x.numpy() @ w.numpy().T, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", ["rank", "width", "dtype", "mixed_dtype",
                                  "inner_stride"])
def test_wrapper_rejects(case):
    x = torch.ones(4, 8)
    w = torch.ones(5, 8)
    args = {
        "rank": (torch.ones(8), w),
        "width": (x, torch.ones(5, 6)),
        "dtype": (x.double(), w.double()),
        "mixed_dtype": (x, w.bfloat16()),
        "inner_stride": (torch.ones(8, 4).T, w),
    }[case]
    with pytest.raises((ValueError, TypeError)):
        chunked_matmul(*args)
