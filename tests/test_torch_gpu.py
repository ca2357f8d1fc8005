"""Tests of the port that need a CUDA card (marker ``gpu``); they skip
without one.  This file imports neither JAX nor the JAX package, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each CUDA kernel is held against its plain version on the card (float32
within 1e-4: the sums run in another order; bfloat16 within 2e-2), and the
engine on the card against the same engine on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.llama_graph import (LlamaSpec,  # noqa: E402
                                          init_llama_params)
from repro_torch.kernels import (chunked_matmul,  # noqa: E402
                                 flash_attention, paged_attention, ref)
from repro_torch.kernels.chunked_matmul import _aligned, _plan  # noqa: E402
from repro_torch.serving.engine import RelationalEngine  # noqa: E402

pytestmark = pytest.mark.gpu

# decode rows (M <= 16 takes the GEMV) and prefill rows (M > 16 the tiled
# GEMM), each at two main-path N x K pairs (split K in both regimes) and
# at a ragged N with a K off the 16-byte vector (the scalar path)
MS = [1, 2, 4, 16, 17, 64]
SHAPES = ([(32, 32, 32), (96, 64, 160), (17, 23, 40), (128, 128, 256),
           (1, 64, 160), (4, 23, 40), (16, 33, 300), (64, 1024, 4096)]
          + [(m, n, k) for m in MS
             for n, k in ((1024, 4096), (4096, 14336), (1023, 301))])
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


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("dtype", list(TOL))
def test_kernel_takes_misaligned_rows(cuda, m, dtype):
    """Rows that start one element past a 16-byte boundary take the scalar
    path; the same values copied to an aligned tensor take the vector
    path.  Both match the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(m)
    dt, k = getattr(torch, dtype), 4096
    wide = torch.randn(m, k + 1, generator=gen, device=cuda).to(dt)
    w = (torch.randn(300, k, generator=gen, device=cuda) / k ** 0.5).to(dt)
    x = wide[:, 1:k + 1]
    dense = x.clone(memory_format=torch.contiguous_format)
    assert not _aligned(x, w) and _aligned(dense, w)
    want = ref.chunked_matmul(x, w).float()
    for xi in (x, dense):
        torch.testing.assert_close(chunked_matmul(xi, w).float(), want,
                                   rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("m", [1, 64])
def test_split_k_launches_are_bit_identical(cuda, m):
    """Split K adds its partials in a fixed order: no float atomics."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(m, 4096, generator=gen, device=cuda)
    w = torch.randn(1024, 4096, generator=gen, device=cuda)
    assert _plan(m, 1024, 4096, torch.float32, True).splits > 1
    first = chunked_matmul(x, w)
    assert all(torch.equal(first, chunked_matmul(x, w)) for _ in range(3))


@pytest.mark.parametrize("m", [1, 4, 64])
def test_chunk_size_never_changes_bits(cuda, m):
    """The chunk tables of one matrix at chunk sizes 16, 64 and 256, viewed
    as [rows, K] as the executor does, give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    n, k = 1024, 4096
    x = torch.randn(m, k, generator=gen, device=cuda)
    w = torch.randn(n, k, generator=gen, device=cuda)
    outs = [chunked_matmul(x.view(m, k // cs, cs).reshape(m, k),
                           w.view(n, k // cs, cs).reshape(n, k))
            for cs in (16, 64, 256)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


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
    k3 = flash_attention.launches
    np.testing.assert_allclose(gpu.start_session(prompt)["logits"],
                               cpu.start_session(prompt)["logits"],
                               rtol=1e-4, atol=1e-4)
    assert chunked_matmul.launches == launches + 7 * spec.n_layers + 1
    assert flash_attention.launches == k3 + spec.n_layers
    k2 = paged_attention.launches
    assert gpu.generate(prompt, 6).tokens == cpu.generate(prompt, 6).tokens
    assert paged_attention.launches == k2 + 5 * spec.n_layers


# ---------------------------------------------------------------------------
# paged_attention (K2) and flash_attention (K3)
# ---------------------------------------------------------------------------

PAGED_LENS = [[5, 17, 32], [1, 1, 1], [32, 8, 24]]
FLASH_SHAPES = [(32, 32, 16, True), (64, 64, 32, True), (32, 64, 16, False),
                (128, 128, 64, True), (17, 40, 128, True), (5, 9, 8, True)]


def _randn(gen, shape, dev, dtype):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _paged_case(cuda, lens, dtype, d=32, unmapped=()):
    """q [3, 8, d] as a strided view, pools [16, 8, 2, d] as views of wider
    tensors (every stride but the inner one off the dense layout), every page
    below a length mapped in shuffled order except the (seq, page) pairs in
    ``unmapped``."""
    gen = torch.Generator(device=cuda).manual_seed(sum(lens) + d)
    B, H, Hkv, page, P, MP = len(lens), 8, 2, 8, 16, 4
    q = _randn(gen, (B, 2 * H, d), cuda, dtype)[:, ::2]
    kp = _randn(gen, (P, page, Hkv + 1, d), cuda, dtype)[:, :, 1:]
    vp = _randn(gen, (P, page + 3, Hkv, d), cuda, dtype)[:, 3:]
    pt = torch.full((B, MP), -1, dtype=torch.int32)
    used = iter(np.random.default_rng(sum(lens)).permutation(P).tolist())
    for b, n in enumerate(lens):
        for i in range(-(-n // page)):
            pt[b, i] = -1 if (b, i) in unmapped else next(used)
    return q, kp, vp, pt.to(cuda), torch.tensor(lens, device=cuda)


@pytest.mark.parametrize("lens", PAGED_LENS)
@pytest.mark.parametrize("dtype", list(TOL))
def test_paged_attention_matches_plain(cuda, lens, dtype):
    q, kp, vp, pt, ln = _paged_case(cuda, lens, getattr(torch, dtype))
    assert not q.is_contiguous() and not kp.is_contiguous()
    launches = paged_attention.launches
    got = paged_attention(q, kp, vp, pt, ln)
    torch.cuda.synchronize()
    assert paged_attention.launches == launches + 1
    torch.testing.assert_close(got.float(),
                               ref.paged_attention(q, kp, vp, pt, ln).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("d", [8, 16, 64, 128])
def test_paged_attention_head_dims(cuda, d):
    q, kp, vp, pt, ln = _paged_case(cuda, [5, 17, 32], torch.float32, d=d)
    torch.testing.assert_close(paged_attention(q, kp, vp, pt, ln),
                               ref.paged_attention(q, kp, vp, pt, ln),
                               rtol=1e-4, atol=1e-4)


def test_paged_attention_skips_unmapped_pages_and_empty_sequences(cuda):
    """The TPU kernel's semantics: an unmapped page below the length is
    skipped (the plain version over the mapped pages only agrees), and a
    sequence of length 0 gives zeros."""
    q, kp, vp, pt, ln = _paged_case(cuda, [20, 17, 32], torch.float32,
                                    unmapped={(0, 1)})
    ln[2] = 0
    got = paged_attention(q, kp, vp, pt, ln)
    # sequence 0 (length 20, pages of 8) without its page 1: the live slots
    # are page 0's 8 and page 2's first 4, i.e. a two-page table of length 12
    pt0 = torch.stack([pt[0, 0], pt[0, 2]])[None]
    want0 = ref.paged_attention(q[:1], kp, vp, pt0,
                                torch.tensor([12], device=cuda))
    torch.testing.assert_close(got[:1], want0, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[1:2], ref.paged_attention(
        q[1:2], kp, vp, pt[1:2], ln[1:2]), rtol=1e-4, atol=1e-4)
    assert torch.count_nonzero(got[2]) == 0


@pytest.mark.parametrize("T,S,d,causal", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", list(TOL))
def test_flash_attention_matches_plain(cuda, T, S, d, causal, dtype):
    """q, k, v as permuted views of [B, T, H, d] tables (the executor's
    layout), k/v with half of q's heads."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(T + S + d)
    q = _randn(gen, (2, T, 4, d), cuda, dt).permute(0, 2, 1, 3)
    k = _randn(gen, (2, S, 2, d), cuda, dt).permute(0, 2, 1, 3)
    v = _randn(gen, (2, S, 2, d), cuda, dt).permute(0, 2, 1, 3)
    launches = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    assert got.stride() == q.stride()
    torch.testing.assert_close(
        got.float(), ref.flash_attention(q, k, v, causal).float(),
        rtol=TOL[dtype], atol=TOL[dtype])


def test_attention_mixed_devices_raise(cuda):
    with pytest.raises(ValueError):
        flash_attention(torch.ones(1, 2, 4, 8), torch.ones(1, 2, 4, 8),
                        torch.ones(1, 2, 4, 8, device=cuda))
    with pytest.raises(ValueError):
        paged_attention(torch.ones(1, 2, 8, device=cuda),
                        torch.ones(2, 4, 2, 8), torch.ones(2, 4, 2, 8),
                        torch.zeros(1, 2, dtype=torch.int32),
                        torch.ones(1, dtype=torch.int32))


def test_paged_attention_rejects_page_ids_past_the_pool(cuda):
    """A page table on the host is bounds-checked before the launch."""
    q, kp, vp, pt, ln = _paged_case(cuda, [5, 17, 32], torch.float32)
    bad = pt.cpu()
    bad[1, 0] = kp.shape[0]
    launches = paged_attention.launches
    with pytest.raises(IndexError):
        paged_attention(q, kp, vp, bad, ln)
    assert paged_attention.launches == launches
