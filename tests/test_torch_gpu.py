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
from repro_torch.kernels._build import sm_count  # noqa: E402
from repro_torch.kernels.chunked_matmul import _aligned, _plan  # noqa: E402
from repro_torch.obs import TraceRecorder  # noqa: E402
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
    assert _plan(m, 1024, 4096, torch.float32, True,
                 sm_count(x.device)).splits > 1
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


# ---------------------------------------------------------------------------
# K2 split-K and K3 on the tensor cores, at the main path's widths
# ---------------------------------------------------------------------------

import importlib  # noqa: E402

from repro_torch.kernels._build import aligned16  # noqa: E402

K2 = importlib.import_module("repro_torch.kernels.paged_attention")
K3 = importlib.import_module("repro_torch.kernels.flash_attention")


def _main_paged(cuda, B, dtype, seed=0):
    """The executor's decode view at Llama-3-8B widths: a [B, 512, 8, 128]
    cache as 64-row pages with an identity page table, 32 query heads."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    S, Hkv, d = 512, 8, 128
    ck = _randn(gen, (B, S, Hkv, d), cuda, dtype)
    cv = _randn(gen, (B, S, Hkv, d), cuda, dtype)
    q = _randn(gen, (B, 32, d), cuda, dtype)
    pt = torch.arange(B * 8, dtype=torch.int32, device=cuda).view(B, 8)
    return q, ck.view(B * 8, 64, Hkv, d), cv.view(B * 8, 64, Hkv, d), pt


def _check_lengths(got, q, kp, vp, pt, ln, tol):
    """Zeros at length 0, the plain version's result elsewhere."""
    live = ln > 0
    assert torch.count_nonzero(got[~live]) == 0
    if live.any():
        want = ref.paged_attention(q, kp, vp, pt, ln)
        torch.testing.assert_close(got[live].float(), want[live].float(),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("dtype", list(TOL))
def test_paged_attention_every_length_to_130(cuda, B, dtype):
    """Every length 0..130 (across the 16-slot split boundaries and the
    64-row pages) at the main path's widths; at B = 4 the sequences take
    lengths n, n + 17, n + 40 and 512 - n."""
    dt = getattr(torch, dtype)
    q, kp, vp, pt = _main_paged(cuda, B, dt)
    for n in range(131):
        lens = [n, n + 17, n + 40, 512 - n][:B]
        ln = torch.tensor(lens, dtype=torch.int32, device=cuda)
        got = paged_attention(q, kp, vp, pt, ln)
        torch.cuda.synchronize()
        _check_lengths(got, q, kp, vp, pt, ln, TOL[dtype])


@pytest.mark.parametrize("n_split", [1, 2, 4, 8, 9, 16])
def test_paged_attention_merge_routes_agree(cuda, n_split):
    """The cluster merge at cluster sizes from one block through the
    portable 8 to the non-portable 16 gives the plain version's result at
    B = 4 (lengths 0, 33, 100 and 512)."""
    q, kp, vp, pt = _main_paged(cuda, 4, torch.float32, seed=1)
    ln = torch.tensor([0, 33, 100, 512], dtype=torch.int32, device=cuda)
    plan = K2.Plan(n_split=n_split, c_min=16, blocks=4 * 8 * n_split)
    got = K2._launch(q, kp, vp, pt, ln, plan)
    torch.cuda.synchronize()
    _check_lengths(got, q, kp, vp, pt, ln, TOL["float32"])


@pytest.mark.parametrize("dtype", list(TOL))
def test_paged_attention_launches_are_bit_identical(cuda, dtype):
    """The splits are merged in split order: no float atomics."""
    q, kp, vp, pt = _main_paged(cuda, 4, getattr(torch, dtype), seed=2)
    ln = torch.tensor([33, 72, 100, 512], dtype=torch.int32, device=cuda)
    first = paged_attention(q, kp, vp, pt, ln)
    assert all(torch.equal(first, paged_attention(q, kp, vp, pt, ln))
               for _ in range(3))


@pytest.mark.parametrize("S", ["T", 512])
@pytest.mark.parametrize("T", [1, 16, 17, 63, 64, 65, 512])
@pytest.mark.parametrize("dtype", list(TOL))
def test_flash_attention_main_widths(cuda, T, S, dtype):
    """Llama-3-8B widths (32 query heads over 8 KV heads, d 128) as the
    executor passes them: q a [1, 32, T, 128] view of a [T, 32, 128]
    table, k/v [1, 8, S, 128] views of [S, 8, 128] tables."""
    S = T if S == "T" else S
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(T * 1000 + S)
    q = _randn(gen, (T, 32, 128), cuda, dt).permute(1, 0, 2)[None]
    k = _randn(gen, (S, 8, 128), cuda, dt).permute(1, 0, 2)[None]
    v = _randn(gen, (S, 8, 128), cuda, dt).permute(1, 0, 2)[None]
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert got.stride() == q.stride()
    torch.testing.assert_close(got.float(),
                               ref.flash_attention(q, k, v).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", list(TOL))
def test_flash_attention_launches_are_bit_identical(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(7)
    dt = getattr(torch, dtype)
    q = _randn(gen, (512, 32, 128), cuda, dt).permute(1, 0, 2)[None]
    k = _randn(gen, (512, 8, 128), cuda, dt).permute(1, 0, 2)[None]
    v = _randn(gen, (512, 8, 128), cuda, dt).permute(1, 0, 2)[None]
    assert K3._plan(1, 512, 512, 32, 8, 128, dt, sm_count(q.device)).balance
    first = flash_attention(q, k, v)
    assert all(torch.equal(first, flash_attention(q, k, v))
               for _ in range(3))


@pytest.mark.parametrize("dtype", list(TOL))
def test_attention_kernels_take_misaligned_views(cuda, dtype):
    """Pools and K/V that start one element off the 16-byte grid take the
    kernels' scalar load paths."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(8)
    n = 16 * 8 * 2 * 64
    kp = _randn(gen, (n + 1,), cuda, dt)[1:].view(16, 8, 2, 64)
    vp = _randn(gen, (n + 1,), cuda, dt)[1:].view(16, 8, 2, 64)
    q = _randn(gen, (3, 8, 64), cuda, dt)
    pt = torch.arange(12, dtype=torch.int32, device=cuda).view(3, 4)
    ln = torch.tensor([5, 17, 32], dtype=torch.int32, device=cuda)
    assert not aligned16(kp, vp)
    torch.testing.assert_close(paged_attention(q, kp, vp, pt, ln).float(),
                               ref.paged_attention(q, kp, vp, pt, ln).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    k = kp.view(1, 2, 128, 64)
    v = vp.view(1, 2, 128, 64)
    qf = _randn(gen, (1, 8, 40, 64), cuda, dt)
    assert not aligned16(k, v)
    torch.testing.assert_close(flash_attention(qf, k, v).float(),
                               ref.flash_attention(qf, k, v).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


# ---------------------------------------------------------------------------
# the prefix cache's suffix prefill: K3 with a causal offset
# ---------------------------------------------------------------------------

# (T, q_offset) over a 512-row cache: offsets on and around the 32-row
# K/V tile's edges, the chatbot prefix (448) and the cache's last rows
SUFFIX_MAIN = ([(T, off) for T in (2, 16, 17, 32, 48)
                for off in (0, 1, 15, 31, 33, 448)]
               + [(T, 512 - T) for T in (2, 17, 48, 64)])


@pytest.mark.parametrize("T,q_offset", SUFFIX_MAIN)
@pytest.mark.parametrize("dtype", list(TOL))
def test_flash_attention_with_query_offset(cuda, T, q_offset, dtype):
    """Llama-3-8B widths (32 query heads over 8 KV heads, d 128) as the
    executor passes a suffix prefill: query row t at position
    q_offset + t sees keys s <= q_offset + t."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(T * 1000 + q_offset)
    q = _randn(gen, (T, 32, 128), cuda, dt).permute(1, 0, 2)[None]
    k = _randn(gen, (512, 8, 128), cuda, dt).permute(1, 0, 2)[None]
    v = _randn(gen, (512, 8, 128), cuda, dt).permute(1, 0, 2)[None]
    launches = flash_attention.launches
    got = flash_attention(q, k, v, q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    torch.testing.assert_close(
        got.float(), ref.flash_attention(q, k, v, q_offset=q_offset).float(),
        rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("T,S,q_offset", [(5, 9, 4), (3, 40, 33),
                                          (17, 64, 1), (40, 100, 60)])
@pytest.mark.parametrize("dtype", list(TOL))
def test_flash_attention_offset_ragged_shapes(cuda, T, S, q_offset, dtype):
    """Ragged T and S, a head dim of 64, two query heads per KV head."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(T + S + q_offset)
    q = _randn(gen, (2, T, 4, 64), cuda, dt).permute(0, 2, 1, 3)
    k = _randn(gen, (2, S, 2, 64), cuda, dt).permute(0, 2, 1, 3)
    v = _randn(gen, (2, S, 2, 64), cuda, dt).permute(0, 2, 1, 3)
    got = flash_attention(q, k, v, q_offset=q_offset)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got.float(), ref.flash_attention(q, k, v, q_offset=q_offset).float(),
        rtol=TOL[dtype], atol=TOL[dtype])


def _prefix_engines(cuda):
    spec = LlamaSpec(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv=2,
                     d_ff=64, rope_theta=10000.0)
    params = init_llama_params(spec, seed=0)
    return spec, {d: RelationalEngine(spec, params, chunk_size=8, max_len=48,
                                      device=d) for d in ("cpu", cuda)}


@pytest.mark.parametrize("tail", [1, 5, 20])
def test_suffix_session_on_the_card_matches_the_cpu(cuda, tail):
    """A 16-token prefix session, then a suffix session of ``tail`` tokens
    over its caches: logits on the card within 1e-4 of the port on the
    CPU, K3 launched with the offset (K2 for one token)."""
    spec, engines = _prefix_engines(cuda)
    rng = np.random.default_rng(tail)
    prompt = [int(t) for t in rng.integers(0, 64, 16 + tail)]
    logits = {}
    for d, eng in engines.items():
        tables = {k: v for k, v in eng.start_session(prompt[:16])[
            "env"].items() if k.startswith(("k_cache", "v_cache"))}
        k2, k3 = paged_attention.launches, flash_attention.launches
        logits[d] = eng.start_suffix_session(prompt, 16, tables)["logits"]
        if d == cuda:
            torch.cuda.synchronize()
            assert (paged_attention.launches - k2,
                    flash_attention.launches - k3) == (
                        (spec.n_layers, 0) if tail == 1
                        else (0, spec.n_layers))
    np.testing.assert_allclose(logits[cuda], logits["cpu"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("mode", ["copy", "share"])
def test_segments_stay_bit_unchanged_on_the_card(cuda, mode):
    """Sequences that share a segment prefill, decode, free and re-admit
    on the card; every segment tensor keeps its bits, and the tokens are
    those of a cold decoder."""
    _, engines = _prefix_engines(cuda)
    eng = engines[cuda]
    hot = eng.batched_decoder(3, prefix_block=4, prefix_bind=mode)
    cold = eng.batched_decoder(3, prefix_block=0)
    prefix = list(range(1, 13))
    hot.prefill_ex(prefix + [0], 0)
    snap = [(t.cols[c], t.cols[c].clone()) for seg in
            hot.prefix_cache._segments for t in seg.tables.values()
            for c in t.cols]
    for round_ in range(2):
        prompts = {1: prefix + [2, round_], 2: prefix + [3, 4, 5, round_]}
        last_h = {s: hot.prefill_ex(p, s) for s, p in prompts.items()}
        assert all(c == 12 for _, c in last_h.values())
        last_h = [t for t, _ in last_h.values()]
        last_c = [cold.prefill(p, s) for s, p in prompts.items()]
        assert last_h == last_c
        for _ in range(4):
            last_h = hot.decode([1, 2], last_h)
            last_c = cold.decode([1, 2], last_c)
            assert last_h == last_c
        hot.free(1)
        hot.free(2)
        torch.cuda.synchronize()
        assert all(torch.equal(t, c) for t, c in snap)


# ---------------------------------------------------------------------------
# the planner's layouts on the card: K1's column layouts, K2/K3 over every
# cache order, the codecs' codes
# ---------------------------------------------------------------------------

# (H, K, Nh): COLH Q, o, W1/W3 at Llama-3-8B widths; ragged small ones
COL_SHAPES = [(32, 4096, 128), (1, 4096, 4096), (1, 4096, 14336),
              (3, 100, 24), (1, 64, 40), (2, 300, 72)]


@pytest.mark.parametrize("H,K,Nh", COL_SHAPES)
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("dtype", list(TOL))
def test_column_kernel_matches_plain(cuda, m, H, K, Nh, dtype):
    gen = torch.Generator(device=cuda).manual_seed(m * H + Nh)
    dt = getattr(torch, dtype)
    x = torch.randn(m, K, generator=gen, device=cuda).to(dt)
    w = (torch.randn(H, K, Nh, generator=gen, device=cuda)
         / K ** 0.5).to(dt)
    launches = chunked_matmul.launches
    got = chunked_matmul(x, w, layout="col")
    torch.cuda.synchronize()
    assert chunked_matmul.launches == launches + 1
    torch.testing.assert_close(got.float(),
                               ref.chunked_matmul(x, w, "col").float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("m", [1, 4, 64])
def test_column_kernel_scalar_path_and_repeats(cuda, m):
    """Blocks at strides off 16 bytes take the scalar path; every launch
    on the same inputs gives the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(m)
    wide = torch.randn(3, 257, 41, generator=gen, device=cuda)
    w = wide[:, 1:, 1:]                      # [3, 256, 40], odd strides
    x = torch.randn(m, 256, generator=gen, device=cuda)
    got = chunked_matmul(x, w, layout="col")
    torch.testing.assert_close(got, ref.chunked_matmul(x, w, "col"),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(got, chunked_matmul(x, w, layout="col"))


@pytest.mark.parametrize("layout", ["row_chunk", "head_major", "pos_major"])
def test_planned_engine_on_the_card_matches_the_cpu(cuda, layout):
    """``row2col="col"`` and each cache layout: prefill logits within 1e-4
    of the port on the CPU, the same tokens single and batched, and every
    matmul and attention subplan launched on its kernel."""
    spec = LlamaSpec(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv=2,
                     d_ff=64, rope_theta=10000.0)
    params = init_llama_params(spec, seed=0)
    cpu, gpu = (RelationalEngine(spec, params, chunk_size=8, max_len=32,
                                 row2col="col", cache_layout=layout,
                                 device=d) for d in ("cpu", cuda))
    prompt = [3, 17, 42, 5]
    k1, k3 = chunked_matmul.launches, flash_attention.launches
    np.testing.assert_allclose(gpu.prefill_logits(prompt),
                               cpu.prefill_logits(prompt), rtol=1e-4,
                               atol=1e-4)
    assert (chunked_matmul.launches - k1, flash_attention.launches - k3) \
        == (7 * spec.n_layers + 1, spec.n_layers)
    k2 = paged_attention.launches
    assert gpu.generate(prompt, 5).tokens == cpu.generate(prompt, 5).tokens
    assert paged_attention.launches == k2 + 4 * spec.n_layers
    decs = [e.batched_decoder(2) for e in (cpu, gpu)]
    last = [[d.prefill([1, 2, 3], 0), d.prefill([9, 8], 1)] for d in decs]
    assert last[0] == last[1]
    for _ in range(3):
        last = [d.decode([0, 1], t) for d, t in zip(decs, last)]
        assert last[0] == last[1]


@pytest.mark.parametrize("name", ["int8", "nf4"])
def test_codes_on_the_card_match_the_cpu(cuda, name):
    """Quantised on the card, the codes and scales of a Llama-3-8B-wide
    table equal those computed on the CPU: no mismatch at all."""
    from repro_torch.quant.codecs import CODECS
    gen = torch.Generator().manual_seed(5)
    data = torch.randn(4096, 64, 64, generator=gen) * 0.02
    cc, cs = CODECS[name].quantise(data)
    gc, gs = CODECS[name].quantise(data.to(cuda))
    assert int((gc.cpu() != cc).sum()) == 0
    assert torch.equal(gs.cpu(), cs)


# ---------------------------------------------------------------------------
# paged residency (WeightPager, LazyEnv) and the shard workers on the card
# ---------------------------------------------------------------------------

from repro_torch.serving.pager import WeightPager  # noqa: E402

TINY = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv=2, d_ff=64,
            rope_theta=10000.0)


@pytest.mark.parametrize("row2col", ["off", "auto"])
@pytest.mark.parametrize("disk", [False, True], ids=["pinned", "disk"])
def test_paged_engine_on_the_card_matches_in_memory(cuda, tmp_path, row2col,
                                                    disk):
    """A budget of a fifth of the weights evicts in the middle of every
    step: the paged engine's logits equal the in-memory engine's on the
    card (bit for bit where both run one plan, ``row2col="off"``; within
    1e-4 where the budget denies column copies), tokens too, and the
    hot set never passes the budget."""
    spec = LlamaSpec(**TINY)
    params = init_llama_params(spec, seed=0)
    total = sum(a.nbytes for a in params.values())
    kw = dict(chunk_size=8, max_len=32, row2col=row2col, device=cuda)
    inm = RelationalEngine(spec, params, **kw)
    paged = RelationalEngine(spec, params, residency="paged",
                             budget_bytes=total // 5,
                             disk_dir=str(tmp_path) if disk else None, **kw)
    prompt = [3, 17, 42, 5]
    a, b = inm.start_session(prompt), paged.start_session(prompt)
    for _ in range(4):
        if row2col == "off":
            np.testing.assert_array_equal(b["logits"], a["logits"])
        np.testing.assert_allclose(b["logits"], a["logits"], rtol=1e-4,
                                   atol=1e-4)
        b["tok"] = a["tok"]
        inm.session_step(a)
        paged.session_step(b)
    stats = paged.pager.stats
    assert stats.evictions > 0 and stats.misses > 0
    assert stats.peak_bytes <= total // 5
    assert paged.generate(prompt, 6).tokens == inm.generate(prompt, 6).tokens


def _pending_stream_work(ms: float = 50.0):
    """Hold the current stream busy for about ``ms`` (a device spin), so
    that what is enqueued next on it runs after the host has moved on."""
    torch.cuda._sleep(int(ms * 1.98e6))


def test_eviction_right_after_a_queued_read_keeps_the_bytes(cuda):
    """Stress: each step fetches the next of three tables (a budget of
    one), queues a K1 launch that reads it behind a device spin, and the
    next step's fetch evicts it — the pager's only reference — while that
    K1 still waits.  The step after allocates the third table: only
    ``record_stream`` keeps the caching allocator from giving it the
    evicted table's bytes before the queued K1 has read them."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    n, k = 1024, 4096
    tables = [torch.randn(n, k, generator=gen, device=cuda).cpu()
              for _ in range(3)]
    nbytes = n * k * 4
    pager = WeightPager(nbytes, policy="pin", device=cuda)
    for i, t in enumerate(tables):
        pager.add(f"w{i}", t)
    x = torch.randn(4, k, generator=gen, device=cuda)
    want = [chunked_matmul(x, t.to(cuda)) for t in tables]
    outs = []
    for step in range(24):
        _pending_stream_work()
        w = pager.get(f"w{step % 3}")  # evicts the table of the last step
        outs.append((step % 3, chunked_matmul(x, w)))
        del w
    torch.cuda.synchronize()
    assert pager.stats.evictions == 23 and pager.held_bytes <= nbytes
    for name, got in outs:
        assert torch.equal(got, want[name])


def test_prefetched_entry_is_waited_on(cuda):
    """The prefetch thread's copy is queued behind a spin on the pager's
    stream and has not run when ``get`` takes the entry: the reading
    stream waits on the entry's event and sees the table's values."""
    gen = torch.Generator().manual_seed(8)
    table = torch.randn(4096, 4096, generator=gen)
    pager = WeightPager(1 << 30, device=cuda)
    pager.add("w", table)
    with torch.cuda.stream(pager._stream):
        _pending_stream_work(100)
    pager.prefetch(["w"]).join(timeout=60)
    _, ready = pager._prefetched["w"]
    assert not ready.query()  # the copy is still queued
    got = pager.get("w")
    assert pager.stats.prefetch_hits == 1 and pager.stats.misses == 0
    assert torch.equal(got.cpu(), table)


def test_pass_schedule_on_the_card_copies_ahead(cuda):
    """A paged engine on the card at a budget of half its pass (one plan:
    row2col off), under the "pin" schedule its first call fixes: the
    logits of later calls equal the in-memory engine's bit for bit, the
    batched decoder's tokens too, at least 9 in 10 of the streamed tables
    come from copies issued ahead (on the pager's stream, waited on by
    the reader's), and the pager holds no more than the budget."""
    spec = LlamaSpec(vocab=512, d_model=256, n_layers=4, n_heads=4, n_kv=2,
                     d_ff=512, rope_theta=10000.0)
    params = init_llama_params(spec, seed=2)
    budget = sum(a.nbytes for a in params.values()) // 2
    kw = dict(chunk_size=16, max_len=32, row2col="off", device=cuda)
    inm = RelationalEngine(spec, params, **kw)
    paged = RelationalEngine(spec, params, residency="paged",
                             budget_bytes=budget, **kw)
    prompt = [3, 17, 42, 5]
    a, b = inm.start_session(prompt), paged.start_session(prompt)
    assert paged.pager.schedule is not None
    before = vars(paged.pager.stats).copy()
    for _ in range(4):
        np.testing.assert_array_equal(b["logits"], a["logits"])
        inm.session_step(a)
        paged.session_step(b)
    decs = [e.batched_decoder(3) for e in (inm, paged)]
    last = [[d.prefill(p, s) for s, p in enumerate(([1, 2, 3], [9, 8],
                                                    [7, 6, 5, 4]))]
            for d in decs]
    for _ in range(6):
        assert last[0] == last[1]
        last = [d.decode([0, 1, 2], t) for d, t in zip(decs, last)]
    assert last[0] == last[1]
    stats = paged.pager.stats
    ahead = stats.prefetch_hits - before["prefetch_hits"]
    assert ahead >= 0.9 * (ahead + stats.misses - before["misses"]) > 0
    assert stats.peak_bytes <= budget


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("residency", ["in_memory", "paged"])
def test_sharded_engine_on_the_card_matches_unsharded(cuda, n, residency):
    """Workers on their own CUDA streams: the sharded engine's tokens equal
    the unsharded engine's on the card, its logits within 1e-4 (partial
    sums add in shard order), and each sharded site launches K1 once a
    shard."""
    spec = LlamaSpec(**dict(TINY, n_layers=1))
    params = init_llama_params(spec, seed=0)
    paged = (dict(residency="paged", budget_bytes=1 << 16)
             if residency == "paged" else {})
    kw = dict(chunk_size=4, max_len=16, device=cuda)
    ref = RelationalEngine(spec, params, **kw)
    eng = RelationalEngine(spec, params, shards=n, **dict(kw, **paged))
    prompt = [3, 17, 42]
    k1 = chunked_matmul.launches
    a = ref.start_session(prompt)
    k1_ref = chunked_matmul.launches - k1
    k1 = chunked_matmul.launches
    b = eng.start_session(prompt)
    sites = eng.shard_pool.stats.sites
    runs = sum(w.metrics.counter("shard_worker_runs_total").value
               for w in eng.shard_pool.workers)
    assert sites > 0 and runs > sites
    assert chunked_matmul.launches - k1 == k1_ref + runs - sites
    for _ in range(4):
        np.testing.assert_allclose(b["logits"], a["logits"], rtol=1e-4,
                                   atol=1e-4)
        b["tok"] = a["tok"]
        ref.session_step(a)
        eng.session_step(b)
    assert eng.generate(prompt, 6).tokens == ref.generate(prompt, 6).tokens
    decs = [e.batched_decoder(2) for e in (ref, eng)]
    last = [[d.prefill([1, 2, 3], 0), d.prefill([9, 8], 1)] for d in decs]
    assert last[0] == last[1]
    for _ in range(3):
        last = [d.decode([0, 1], t) for d, t in zip(decs, last)]
        assert last[0] == last[1]
    eng.shard_pool.shutdown()


@pytest.mark.parametrize("residency", ["in_memory", "paged"])
def test_traced_tick_on_the_card_matches_untraced(cuda, residency):
    """A traced engine on the card (each step span records a pair of
    events on the current stream, read after the call's logits) gives the
    untraced engine's logits and batched tokens bit for bit, records one
    ``cat="step"`` span a pipeline step with a positive duration and
    ``device_us``, and, paged, the pager's spans: one ``pager_fetch:`` a
    miss and one ``pager_prefetch:`` a copy its "pin" schedule (fixed by
    the first call) issued ahead, which after that call are all of
    them."""
    spec = LlamaSpec(**dict(TINY, n_layers=2))
    params = init_llama_params(spec, seed=0)
    paged = (dict(residency="paged", budget_bytes=1 << 16)
             if residency == "paged" else {})
    kw = dict(chunk_size=4, max_len=16, device=cuda, **paged)
    tracer = TraceRecorder()
    plain = RelationalEngine(spec, params, **kw)
    traced = RelationalEngine(spec, params, tracer=tracer, **kw)
    prompt = [3, 17, 42]
    a, b = plain.start_session(prompt), traced.start_session(prompt)
    for _ in range(3):
        assert np.array_equal(a["logits"], b["logits"])
        plain.session_step(a)
        traced.session_step(b)
    tracer.clear()
    decs = [e.batched_decoder(2) for e in (plain, traced)]
    last = [[d.prefill([1, 2, 3], 0), d.prefill([9, 8], 1)] for d in decs]
    for _ in range(3):
        assert last[0] == last[1]
        last = [d.decode([0, 1], t) for d, t in zip(decs, last)]
    assert last[0] == last[1]
    steps = [e for e in tracer.events if e.cat == "step"]
    per_tick = len(traced._batched_decode_pipe(2).steps)
    assert len(steps) == len(traced._prefill_pipe(3).steps) + len(
        traced._prefill_pipe(2).steps) + 3 * per_tick
    assert all(e.dur_us > 0 and e.depth == 0 for e in steps)
    assert all(e.args["device_us"] > 0 for e in steps)
    fetches = [e for e in tracer.events
               if e.name.startswith(("pager_fetch:", "pager_prefetch:"))]
    assert bool(fetches) == (residency == "paged")


def test_sharded_traced_step_on_the_card_gives_worker_spans(cuda):
    """``shards=2`` with a tracer on the card: every sharded site of a step
    gives one ``"{step}::shard{s}"`` span in each worker's recorder (its
    dispatch, with the device time of the worker's stream as
    ``device_us``), the merged trace puts the coordinator and the two
    workers on three pids, and the logits equal the untraced sharded
    engine's."""
    spec = LlamaSpec(**dict(TINY, n_layers=1))
    params = init_llama_params(spec, seed=0)
    kw = dict(chunk_size=4, max_len=16, device=cuda, shards=2)
    plain = RelationalEngine(spec, params, **kw)
    traced = RelationalEngine(spec, params, tracer=TraceRecorder(), **kw)
    prompt = [3, 17, 42]
    a, b = plain.start_session(prompt), traced.start_session(prompt)
    plain.session_step(a)
    traced.session_step(b)
    assert np.array_equal(a["logits"], b["logits"])
    sites = traced.shard_pool.stats.sites
    for w in traced.shard_pool.workers:
        spans = [e for e in w.tracer.events if e.cat == "shard"]
        assert len(spans) == sites > 0
        assert all(e.name.endswith(f"::shard{w.index}") and e.dur_us > 0
                   and e.args["device_us"] > 0 for e in spans)
    merged = traced.merged_shard_trace()
    assert {e["pid"] for e in merged["traceEvents"]} == {1, 2, 3}
    for eng in (plain, traced):
        eng.shard_pool.shutdown()


def _device_events(prof):
    """``(start_ns, end_ns, name)`` of every kernel and copy the profiler
    saw on the card, on its clock."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        a = (ev.start_ns() if hasattr(ev, "start_ns")
             else int(ev.start_us() * 1000))
        out.append((a, a + (ev.duration_ns() if hasattr(ev, "duration_ns")
                            else int(ev.duration_us() * 1000)), ev.name()))
    return out


def _busy_ns(events):
    busy, end = 0, None
    for a, b, _ in sorted(events):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def _spin_cycles(ms: float) -> int:
    """``torch.cuda._sleep`` cycles that keep the card busy ~``ms``."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(10 ** 8)
    end.record()
    torch.cuda.synchronize()
    return int(10 ** 8 * ms / start.elapsed_time(end))


def _profiled(fn):
    """``fn()`` under a CUDA-only profiler, and the card's events; the
    profiler is started once first, so CUPTI is up before ``fn`` runs."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
    return out, _device_events(prof)


class _SpinAfterFirstStep(TraceRecorder):
    """A recorder that, once armed with ``cycles``, queues a spin on the
    card right after the next step span closes: the host then dispatches
    the rest of the call while the card spins."""

    cycles = 0

    def _record(self, name, cat, *rest):
        rec = super()._record(name, cat, *rest)
        if self.cycles and cat == "step":
            torch.cuda._sleep(self.cycles)
            self.cycles = 0
        return rec


@pytest.fixture(scope="module")
def paged_8b():
    """An engine at Llama-3-8B width, two layers paged through 256 MiB
    (every table streamed from pinned host memory), traced by a
    :class:`_SpinAfterFirstStep`, with two slots prefilled and decoded
    twice (the allocator's cache then holds a call's blocks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.llama_graph import init_llama_tensors
    spec = LlamaSpec(vocab=32000, d_model=4096, n_layers=2, n_heads=32,
                     n_kv=8, d_ff=14336, rope_theta=500000.0)
    tracer = _SpinAfterFirstStep()
    eng = RelationalEngine(spec, init_llama_tensors(spec, seed=0,
                                                    device="cuda"),
                           chunk_size=64, max_len=576, residency="paged",
                           budget_bytes=1 << 28, tracer=tracer,
                           device="cuda")
    dec = eng.batched_decoder(2)
    last = [dec.prefill([1, 2, 3], 0), dec.prefill([9, 8], 1)]
    for _ in range(2):
        last = dec.decode([0, 1], last)
    return eng, dec, last


def _spun_call(eng, fn):
    """``fn()`` with a ~200 ms spin after its first step, profiled: the
    spin's event, the later step records and the card's events."""
    from repro_torch.obs.trace import CAT
    tracer = eng.tracer
    cycles = _spin_cycles(200.0)
    tracer.clear()

    def call():
        tracer.cycles = cycles
        return fn()
    _, events = _profiled(call)
    spin = max(events, key=lambda e: e[1] - e[0])
    assert spin[1] - spin[0] > 150e6
    steps = [r for r in tracer._records if r[CAT] == "step"]
    return spin, steps[1:], events


def test_step_spans_wait_for_nothing(paged_8b):
    """A traced paged decode call with the card spinning from its second
    step on: every later step span ends before the spin does, so none
    waited on the stream.  (The first step is the embedding's value join,
    whose range check reads the token ids on the host: a wait at the
    call's start, where the stream holds little.)"""
    from repro_torch.obs.trace import DUR, TS
    eng, dec, last = paged_8b
    spin, rest, _ = _spun_call(eng, lambda: dec.decode([0, 1], last))
    assert rest
    last_step_end = max(eng.tracer.epoch_ns + (r[TS] + r[DUR]) * 1e3
                        for r in rest)
    assert last_step_end < spin[1], (last_step_end - spin[1]) / 1e6


def test_step_device_times_add_up_to_the_cards_busy_time(paged_8b):
    """A traced 512-token prefill (its tables copied while the card spins
    after the first step, its GEMMs then long beside the gaps between
    kernels): the later steps' ``device_us`` add up to within 10 % of the
    card's busy time after the spin."""
    from repro_torch.obs.trace import record_arg
    eng, _, _ = paged_8b
    prompt = [int(t) for t in torch.arange(512) % 32000]
    eng.start_session(prompt)
    spin, rest, events = _spun_call(eng, lambda: eng.start_session(prompt))
    after = [(max(a, spin[1]), b, n) for a, b, n in events
             if b > spin[1] and (a, b, n) != spin]
    device_us = sum(record_arg(r, "device_us") for r in rest)
    busy_us = _busy_ns(after) / 1e3
    assert abs(device_us - busy_us) <= 0.1 * busy_us, (device_us, busy_us)


def test_span_and_profiler_share_a_clock(cuda):
    """A span around a ~50 ms spin on the card and a synchronise brackets
    the profiler's event for that spin to within 50 µs at both edges: the
    tracer's ``epoch_ns + ts_us * 1000`` and the profiler's timestamps are
    on one clock."""
    from repro_torch.obs.trace import DUR, TS
    cycles = _spin_cycles(50.0)
    tracer = TraceRecorder()

    def spin():
        with tracer.span("spin", cat="step"):
            torch.cuda._sleep(cycles)
            torch.cuda.synchronize()
    _, events = _profiled(spin)
    rec, = tracer._records
    s0 = tracer.epoch_ns + rec[TS] * 1e3
    s1 = s0 + rec[DUR] * 1e3
    k0, k1, _ = max(events, key=lambda e: e[1] - e[0])
    assert k1 - k0 > 40e6
    assert s0 - 50e3 <= k0 and k1 <= s1 + 50e3, ((k0 - s0) / 1e3,
                                                 (s1 - k1) / 1e3)


# -- the dense baseline: the model stack and DirectEngine ----------------------

def _pinned(tree):
    from repro_torch.models.transformer import tree_map
    return tree_map(lambda t: t.pin_memory(), tree)


@pytest.mark.parametrize("residency", ["in_memory", "paged"])
def test_direct_engine_on_the_card_matches_the_cpu(cuda, residency):
    """A tiny ``DirectEngine`` on the card gives the CPU engine's tokens, in
    memory and paged from pinned host memory through a working set below
    the tree (the pager's stats equal the CPU pager's)."""
    from repro_torch.core.bridge import llama_params_to_tree, spec_to_config
    from repro_torch.serving.engine import DirectEngine
    spec = LlamaSpec(**dict(TINY, n_layers=2))
    params = init_llama_params(spec, seed=3)
    cfg = spec_to_config(spec)
    kw = dict(max_len=32)
    if residency == "paged":
        kw.update(residency="paged", budget_bytes=48 * 1024)
    res = {}
    for dev in (cuda, torch.device("cpu")):
        paged = residency == "paged"
        tree = llama_params_to_tree(params, spec,
                                    device="cpu" if paged else dev)
        if paged and dev.type == "cuda":
            tree = _pinned(tree)
        res[dev.type] = DirectEngine(cfg, tree, device=dev, **kw).generate(
            [5, 9, 2, 7], max_new_tokens=6)
    assert res["cuda"].tokens == res["cpu"].tokens
    assert res["cuda"].pager_stats == res["cpu"].pager_stats
    if residency == "paged":
        assert res["cuda"].pager_stats["evictions"] > 0


def test_model_families_on_the_card_match_the_cpu(cuda):
    """Every assigned family at its TINY size: ``forward``, then ``prefill``
    and three ``decode_step``s on the card against the CPU, the same
    weights carried across (f32 within 1e-4)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import ASSIGNED
    from repro_torch.models import transformer as tf
    for arch in ASSIGNED + ["llama3-8b"]:
        cfg = get_config(arch, tiny=True)
        cpu_p = tf.init_params(cfg, 0, device="cpu")
        gpu_p = tf.tree_map(lambda t: t.to(cuda), cpu_p)
        gen = torch.Generator().manual_seed(1)
        toks = torch.randint(0, cfg.vocab, (2, 10), generator=gen)
        aux = None
        if cfg.family in ("encdec", "vlm"):
            n = cfg.n_frames if cfg.family == "encdec" else cfg.n_image_tokens
            aux = torch.randn(2, n, cfg.d_model, generator=gen)
        out = {}
        for dev, p in ((cuda, gpu_p), (torch.device("cpu"), cpu_p)):
            batch = {"tokens": toks.to(dev)}
            if aux is not None:
                batch["frames" if cfg.family == "encdec" else "images"] = \
                    aux.to(dev)
            logits = [tf.forward(p, batch, cfg)]
            caches = tf.init_caches(cfg, 2, 10, dtype=torch.float32,
                                    device=dev)
            lg, caches, ac = tf.prefill(
                p, batch["tokens"][:, :7], cfg, caches,
                aux_input=None if aux is None else aux.to(dev))
            logits.append(lg)
            for i in range(3):
                lg, caches = tf.decode_step(p, batch["tokens"][:, 7 + i:8 + i],
                                            caches, 7 + i, cfg,
                                            aux_caches=ac)
                logits.append(lg)
            out[dev.type] = [t.cpu() for t in logits]
        for g, c in zip(out["cuda"], out["cpu"]):
            torch.testing.assert_close(g, c, rtol=1e-4, atol=1e-4,
                                       msg=lambda m: f"{arch}: {m}")


def test_moe_dispatch_with_drops_on_the_card(cuda):
    """The sort-based MoE dispatch where capacity drops (token, k) pairs
    (the default factor 1.25, tokens sharing a component): the card's
    outputs equal the CPU's within 1e-4."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config("olmoe-1b-7b", tiny=True),
                              capacity_factor=1.25)
    p = moe.moe_init(torch.Generator().manual_seed(4), cfg, device="cpu")
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(cfg.d_model, generator=gen) + 0.3 * torch.randn(
        4, 64, cfg.d_model, generator=gen)
    N = x.shape[0] * x.shape[1]
    _, idx = moe.top_k(torch.softmax(x.reshape(N, -1) @ p["router"], -1),
                       cfg.top_k)
    assert int(torch.bincount(idx.reshape(-1)).max()) > moe.capacity(N, cfg)
    got = moe.moe_apply({k: v.to(cuda) for k, v in p.items()}, x.to(cuda),
                        cfg)
    torch.testing.assert_close(got.cpu(), moe.moe_apply(p, x, cfg),
                               rtol=1e-4, atol=1e-4)


# -- training: the train step, remat and the recovery driver -------------------

def _assert_step_params(got, want, lr, tol=1e-5):
    """One AdamW step's params: within ``tol`` except for sign flips of
    near-zero gradients (at most 0.1 % of a leaf, each within 2·lr)."""
    diff = (got.float() - want.float()).abs()
    assert float((diff > tol).float().mean()) <= 1e-3, float(diff.max())
    assert float(diff.max()) <= 2 * lr * (1 + 1e-4) + tol


def _train_batch(cfg, dev, step=0, seq=16, batch=4):
    from repro_torch.data.pipeline import SyntheticLM
    b = {k: torch.from_numpy(v) for k, v in SyntheticLM(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch).batch_at(
        step).items()}
    gen = torch.Generator().manual_seed(step)
    if cfg.family == "encdec":
        b["frames"] = torch.randn(batch, cfg.n_frames, cfg.d_model,
                                  generator=gen)
    if cfg.family == "vlm":
        b["images"] = torch.randn(batch, cfg.n_image_tokens, cfg.d_model,
                                  generator=gen)
    return {k: v.to(dev) for k, v in b.items()}


@pytest.mark.parametrize("arch", ["qwen3-14b", "granite-34b", "olmo-1b",
                                  "phi4-mini-3.8b", "hymba-1.5b",
                                  "olmoe-1b-7b", "deepseek-v3-671b",
                                  "mamba2-2.7b", "whisper-small",
                                  "llama-3.2-vision-90b", "llama3-8b"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """Two train steps of every family's TINY config (f32) on the card
    against the CPU from the same weights: loss, grad_norm and lr within
    1e-5, params within 1e-5 outside Adam's sign flips."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_loop import make_train_step
    cfg = get_config(arch, tiny=True)
    lr = 1e-3
    opt = AdamW(lr=lr, warmup_steps=1, total_steps=40)
    step = make_train_step(cfg, opt)
    cpu_p = tf.init_params(cfg, 0, device="cpu")
    gpu_p = tf.tree_map(lambda t: t.to(cuda), cpu_p)
    states = {"cpu": opt.init(cpu_p), "cuda": opt.init(gpu_p)}
    for i in range(2):
        ms = {}
        for dev, p in (("cuda", gpu_p), ("cpu", cpu_p)):
            _, states[dev], ms[dev] = step(p, states[dev],
                                           _train_batch(cfg, dev, i))
        for k in ("loss", "grad_norm", "lr"):
            assert float(ms["cuda"][k]) == pytest.approx(
                float(ms["cpu"][k]), rel=1e-5, abs=1e-6), (arch, k, i)
        for g, c in zip(tf.tree_leaves(gpu_p), tf.tree_leaves(cpu_p)):
            _assert_step_params(g.cpu(), c, lr)


def test_remat_on_the_card_matches_no_remat(cuda):
    """Llama-3's TINY config at bf16 and f32: ``remat="full"`` gives the
    loss and gradients of ``remat="none"`` within 1e-6 on the card."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.training.train_loop import loss_fn
    for dtype in ("float32", "bfloat16"):
        base = dataclasses.replace(get_config("llama3-8b", tiny=True),
                                   dtype=dtype, param_dtype=dtype)
        params = tf.init_params(base, 0, device=cuda)
        batch = _train_batch(base, cuda)
        out = {}
        for remat in ("none", "full"):
            live = [p.detach().requires_grad_(True)
                    for p in tf.tree_leaves(params)]
            loss, _ = loss_fn(tf.tree_unflatten(params, live), batch,
                              dataclasses.replace(base, remat=remat))
            out[remat] = [loss] + list(torch.autograd.grad(loss, live))
        for a, b in zip(out["none"], out["full"]):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_restart_on_the_card_reproduces_uninterrupted_run(cuda, tmp_path):
    """The recovery driver on the card (Llama-3's TINY config): a crash at
    step 9 after the step-8 checkpoint, then a resume, ends on the
    uninterrupted run's loss (abs 1e-6, the reference's bar)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.training.fault_tolerance import (FaultConfig,
                                                      run_with_recovery)
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_loop import make_train_step
    cfg = get_config("llama3-8b", tiny=True)
    opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=40)
    step = make_train_step(cfg, opt)

    def init_state():
        p = tf.init_params(cfg, 0, device=cuda)
        return p, opt.init(p)

    def batch_at(i):
        return _train_batch(cfg, cuda, i)
    runs = [run_with_recovery(step, init_state, batch_at, total_steps=12,
                              fault_cfg=FaultConfig(
                                  ckpt_dir=str(tmp_path / name),
                                  ckpt_every=4), fail_at=fail_at)
            for name, fail_at in (("ref", None), ("ft", {9: 0}))]
    assert [r.restarts for r in runs] == [0, 1]
    assert runs[0].steps_run == runs[1].steps_run == 12
    assert runs[1].losses[-1] == pytest.approx(runs[0].losses[-1], abs=1e-6)


# -- the distributed path at world size 1 (NCCL) --------------------------------


@pytest.fixture
def nccl_world(cuda, tmp_path):
    """A one-rank NCCL process group (NCCL takes one rank per card; its
    rendezvous a FileStore under ``tmp_path``), destroyed after the test."""
    import torch.distributed as dist
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield cuda
    finally:
        dist.destroy_process_group()


def _dist_case():
    import dataclasses
    from repro_torch.configs.llama3_2_3b import CONFIG
    return dataclasses.replace(CONFIG, n_layers=2)


def test_mesh_train_step_on_the_card_is_bit_equal_to_the_plain_step(
        nccl_world):
    """Llama-3.2-3B's width at depth 2 (bf16, remat): the train step on
    DTensor leaves placed by ``param_pspecs`` on a (1, 1) mesh under
    single_pod_rules(fsdp=True) gives the plain step's loss, grad_norm and
    params bit for bit."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed.sharding import (
        distribute_tree, placements, sharding_rules, single_pod_rules)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_loop import (batch_pspec,
                                                 make_train_step,
                                                 param_pspecs)
    cfg = _dist_case()
    opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, opt)
    batch = _train_batch(cfg, nccl_world, seq=64, batch=2)
    plain = tf.init_params(cfg, 0, device=nccl_world)
    _, _, want = step(plain, opt.init(plain), batch)
    mesh = make_test_mesh(1, 1)
    with sharding_rules(mesh, single_pod_rules(fsdp=True)):
        params = tf.init_params(cfg, 0, device=nccl_world)
        params = distribute_tree(params, param_pspecs(params, mesh), mesh)
        bsh = {k: distribute_tensor(v, mesh, placements(batch_pspec(), mesh))
               for k, v in batch.items()}
        _, _, got = step(params, opt.init(params), bsh)
    for k in ("loss", "grad_norm"):
        g = got[k].full_tensor() if hasattr(got[k], "full_tensor") else got[k]
        assert torch.equal(g, want[k]), k
    for a, b in zip(tf.tree_leaves(params), tf.tree_leaves(plain)):
        assert torch.equal(a.full_tensor(), b)


def test_restore_onto_a_mesh_on_the_card_is_exact(nccl_world, tmp_path):
    """A checkpoint saved from a (1, 1) mesh, restored onto a (1, 1, 1)
    ("pod", "data", "model") mesh under multi_pod_rules(fsdp=True): equal
    leaves, placed by ``param_pspecs``, and a manifest byte-equal to an
    unsharded save's."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.sharding import (
        NamedSharding, distribute_tree, multi_pod_rules, placements,
        sharding_rules, single_pod_rules)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.train_loop import param_pspecs
    cfg = _dist_case()
    plain = tf.init_params(cfg, 0, device=nccl_world)
    mesh, mesh3 = make_test_mesh(1, 1), make_test_mesh(1, 1, pods=1)
    with sharding_rules(mesh, single_pod_rules(fsdp=True)):
        params = distribute_tree(plain, param_pspecs(plain, mesh), mesh)
    ckpt.save(str(tmp_path / "sharded"), 1, params)
    ckpt.save(str(tmp_path / "plain"), 1, plain)
    name = "step_00000001/manifest.json"
    assert ((tmp_path / "sharded" / name).read_bytes()
            == (tmp_path / "plain" / name).read_bytes())
    abstract = tf.tree_map(lambda t: torch.empty_like(t, device="meta"),
                           plain)
    with sharding_rules(mesh3, multi_pod_rules(fsdp=True)):
        specs3 = param_pspecs(abstract, mesh3)
    restored, _ = ckpt.restore(
        str(tmp_path / "sharded"), 1, abstract,
        tf.tree_map(lambda s: NamedSharding(mesh3, placements(s, mesh3)),
                    specs3))
    for t, s, want in zip(tf.tree_leaves(restored), tf.tree_leaves(specs3),
                          tf.tree_leaves(plain)):
        assert isinstance(t, DTensor)
        assert tuple(t.placements) == placements(s, mesh3)
        assert torch.equal(t.full_tensor(), want)
