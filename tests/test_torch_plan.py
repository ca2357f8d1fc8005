"""The tiling plan of K1 ``chunked_matmul`` (``_plan``), on the CPU.

``_plan`` is plain Python: it picks the regime (decode GEMV for M ≤ 16,
prefill GEMM above), the tile, the K split and the workspace, and the CUDA
side only carries them out.  These tests hold it to what the kernels need
and to what fills the card: at least 132 blocks (one per SM) for a decode
step and a 64-token prefill; a decode split of at most 8 slabs (one
cluster, no workspace) whose X slab fits the kernel's 112 KB of shared
memory; a prefill split that stays within one wave of resident blocks on
the card's SMs, with a workspace of exactly its partials; the scalar path
wherever the 16-byte vector path cannot read the inputs.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.chunked_matmul import (  # noqa: E402
    DECODE_MAX_M, GEMM_RESIDENT, GEMV_MAX_SPLITS, GEMV_SLAB_BYTES, SMS,
    _aligned, _plan)

# Llama-3-8B's GEMM sites (N x K)
MAIN_NK = {"o/Q": (4096, 4096), "K/V": (1024, 4096), "W1/W3": (14336, 4096),
           "W2": (4096, 14336), "lm_head": (128256, 4096)}
MAIN_M = [1, 2, 4, 16, 17, 32, 64]
EDGE = [(1, 1023, 301), (2, 100, 301), (16, 33, 300), (17, 23, 40),
        (64, 1023, 301), (3, 5, 0), (1, 1, 1), (5, 300, 4096),
        (512, 4096, 4096), (96, 64, 160), (16, 64, 32768), (8, 7, 100000)]
DTYPES = [torch.float32, torch.bfloat16]


def _check_plan(p, m, n, k, dtype, aligned, sms=SMS):
    """What the CUDA side requires of a plan (``run`` in the .cu source
    returns an error otherwise) and what makes it the right one."""
    if m > DECODE_MAX_M:
        assert p.regime == "prefill"
    if p.regime == "decode":
        assert p.tile[0] in (1, 2, 4, 8, 16) and m <= p.tile[0] < 2 * m
        assert p.tile[1:] == ((16 if m == 1 else 32), 128)
        assert 4 * p.tile[0] * p.kslab <= GEMV_SLAB_BYTES
        assert p.splits <= GEMV_MAX_SPLITS and p.workspace == 0
        assert p.blocks == -(-n // p.tile[1]) * p.splits
    else:
        assert p.tile == ((32, 128, 32) if m <= 32 else (64, 128, 16))
        assert p.kslab % p.tile[2] == 0
        assert p.blocks == (-(-n // p.tile[1]) * -(-m // p.tile[0])
                            * p.splits)
        assert p.workspace == (4 * p.splits * m * n if p.splits > 1 else 0)
        # a split never spills the grid past one wave of resident blocks
        assert p.splits == 1 or p.blocks <= GEMM_RESIDENT * sms
    assert p.vec == (16 // dtype.itemsize if aligned else 1)
    assert p.kslab % p.vec == 0
    # the slabs cover K, and none is empty
    assert p.splits >= 1 and p.splits * p.kslab >= k
    assert (p.splits - 1) * p.kslab < max(k, 1)


@pytest.mark.parametrize("m", MAIN_M)
@pytest.mark.parametrize("site", list(MAIN_NK))
def test_main_shapes(site, m):
    n, k = MAIN_NK[site]
    p = _plan(m, n, k, torch.float32, True)
    _check_plan(p, m, n, k, torch.float32, True)
    assert p.regime == ("decode" if m <= DECODE_MAX_M else "prefill")


@pytest.mark.parametrize("m", [1, 64])
@pytest.mark.parametrize("site", list(MAIN_NK))
def test_main_shapes_fill_the_card(site, m):
    """A decode step (M = 1) and a 64-token prefill put at least one block
    on every SM at every GEMM site."""
    p = _plan(m, *MAIN_NK[site], torch.float32, True)
    assert p.blocks >= SMS, p


@pytest.mark.parametrize("sms", [114, 132])
@pytest.mark.parametrize("site", list(MAIN_NK))
def test_prefill_split_follows_the_sm_count(site, sms):
    """The prefill split is sized from the card's SM count (an H100 PCIe
    has 114, an SXM 132), so it never starts a second, nearly empty wave
    of resident blocks."""
    n, k = MAIN_NK[site]
    p = _plan(64, n, k, torch.float32, True, sms)
    _check_plan(p, 64, n, k, torch.float32, True, sms)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,k", EDGE)
def test_edge_shapes(m, n, k, dtype, aligned):
    _check_plan(_plan(m, n, k, dtype, aligned), m, n, k, dtype, aligned)


@pytest.mark.parametrize("m", range(1, 33))
def test_regime_switches_after_sixteen_rows(m):
    p = _plan(m, 4096, 4096, torch.float32, True)
    assert p.regime == ("decode" if m <= 16 else "prefill")


def test_split_k():
    """Decode: four slabs (a cluster of four) wherever K allows 512-deep
    ones, eight where 16 X rows of W2's K = 14336 would not fit in 112 KB.
    Prefill at M = 64: o/Q's 32 tiles split 8 ways to fill one wave of 264
    resident blocks, W1/W3's 112 two ways, and lm_head's 1002 not at all."""
    assert _plan(1, 1024, 4096, torch.float32, True).splits == 4
    assert _plan(1, 128256, 4096, torch.float32, True).splits == 4
    assert _plan(1, 64, 1500, torch.float32, True).splits == 2
    assert _plan(1, 64, 300, torch.float32, True).splits == 1
    assert _plan(16, 4096, 14336, torch.float32, True).splits == 8
    assert _plan(64, 4096, 4096, torch.float32, True).splits == 8
    assert _plan(64, 14336, 4096, torch.float32, True).splits == 2
    assert _plan(64, 128256, 4096, torch.float32, True).splits == 1


def test_decode_too_deep_for_shared_memory_takes_the_gemm():
    """16 rows of a 32768-deep X need 256 KB in 8 slabs: past the GEMV's
    112 KB, so the tiled GEMM (any depth) takes the call."""
    p = _plan(16, 64, 32768, torch.float32, True)
    assert p.regime == "prefill"
    _check_plan(p, 16, 64, 32768, torch.float32, True)


@pytest.mark.parametrize("dtype", DTYPES)
def test_alignment_picks_the_path(dtype):
    """The vector path needs 16-byte aligned pointers and row strides and
    K in whole 16-byte vectors; anything else is planned scalar."""
    k = 64
    wide = torch.zeros(4, k + 1, dtype=dtype)
    w = torch.zeros(8, k, dtype=dtype)
    assert not _aligned(wide[:, :k], w)  # row stride k + 1: off the grid
    assert not _aligned(wide[:, 1:], w)  # starts one element in
    assert _aligned(wide[:, 1:].contiguous(), w)
    assert _aligned(wide[:1, :k], w)     # one row: its stride is not read
    assert not _aligned(torch.zeros(4, 30, dtype=dtype),
                        torch.zeros(8, 30, dtype=dtype))
    assert _plan(4, 8, 30, dtype, False).vec == 1
    assert _plan(4, 8, k, dtype, True).vec == 16 // dtype.itemsize


def test_plan_rejects():
    with pytest.raises(TypeError):
        _plan(1, 8, 8, torch.float64, True)
    with pytest.raises(ValueError):
        _plan(0, 8, 8, torch.float32, True)
