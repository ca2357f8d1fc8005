"""The plans of the port's kernels (each module's ``_plan``), on the CPU.

K1 ``chunked_matmul``:

``_plan`` is plain Python: it picks the regime (decode GEMV for M ≤ 16,
prefill GEMM above), the tile, the K split and the workspace, and the CUDA
side only carries them out.  These tests hold it to what the kernels need
and to what fills the card: at least 132 blocks (one per SM) for a decode
step and a 64-token prefill; a decode split of at most 8 slabs (one
cluster, no workspace) whose X slab fits the kernel's 112 KB of shared
memory; a prefill split that stays within one wave of resident blocks on
the card's SMs, with a workspace of exactly its partials; the scalar path
wherever the 16-byte vector path cannot read the inputs.

K2 ``paged_attention``: the split of each (sequence, KV head) over the
blocks of one cluster, and its slot ranges.  K3 ``flash_attention``:
warps, query heads and rows of a block, the balance of causal work, shared
memory.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.chunked_matmul import (  # noqa: E402
    DECODE_MAX_M, GEMM_RESIDENT, GEMV_MAX_SPLITS, GEMV_SLAB_BYTES, _aligned,
    _plan)

SMS = 132  # streaming multiprocessors of an H100 SXM (114 on a PCIe card)

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
    p = _plan(m, n, k, torch.float32, True, SMS)
    _check_plan(p, m, n, k, torch.float32, True)
    assert p.regime == ("decode" if m <= DECODE_MAX_M else "prefill")


@pytest.mark.parametrize("m", [1, 64])
@pytest.mark.parametrize("site", list(MAIN_NK))
def test_main_shapes_fill_the_card(site, m):
    """A decode step (M = 1) and a 64-token prefill put at least one block
    on every SM at every GEMM site."""
    p = _plan(m, *MAIN_NK[site], torch.float32, True, SMS)
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
    _check_plan(_plan(m, n, k, dtype, aligned, SMS), m, n, k, dtype, aligned)


@pytest.mark.parametrize("m", range(1, 33))
def test_regime_switches_after_sixteen_rows(m):
    p = _plan(m, 4096, 4096, torch.float32, True, SMS)
    assert p.regime == ("decode" if m <= 16 else "prefill")


def test_split_k():
    """Decode: four slabs (a cluster of four) wherever K allows 512-deep
    ones, eight where 16 X rows of W2's K = 14336 would not fit in 112 KB.
    Prefill at M = 64: o/Q's 32 tiles split 8 ways to fill one wave of 264
    resident blocks, W1/W3's 112 two ways, and lm_head's 1002 not at all."""
    assert _plan(1, 1024, 4096, torch.float32, True, SMS).splits == 4
    assert _plan(1, 128256, 4096, torch.float32, True, SMS).splits == 4
    assert _plan(1, 64, 1500, torch.float32, True, SMS).splits == 2
    assert _plan(1, 64, 300, torch.float32, True, SMS).splits == 1
    assert _plan(16, 4096, 14336, torch.float32, True, SMS).splits == 8
    assert _plan(64, 4096, 4096, torch.float32, True, SMS).splits == 8
    assert _plan(64, 14336, 4096, torch.float32, True, SMS).splits == 2
    assert _plan(64, 128256, 4096, torch.float32, True, SMS).splits == 1


def test_decode_too_deep_for_shared_memory_takes_the_gemm():
    """16 rows of a 32768-deep X need 256 KB in 8 slabs: past the GEMV's
    112 KB, so the tiled GEMM (any depth) takes the call."""
    p = _plan(16, 64, 32768, torch.float32, True, SMS)
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
    assert _plan(4, 8, 30, dtype, False, SMS).vec == 1
    assert _plan(4, 8, k, dtype, True, SMS).vec == 16 // dtype.itemsize


def test_plan_rejects():
    with pytest.raises(TypeError):
        _plan(1, 8, 8, torch.float64, True, SMS)
    with pytest.raises(ValueError):
        _plan(0, 8, 8, torch.float32, True, SMS)


# ---------------------------------------------------------------------------
# K2 paged_attention: the split of each (sequence, KV head) over blocks
# ---------------------------------------------------------------------------

import importlib  # noqa: E402

# the modules (the package's names of the same spelling are the wrappers)
K2 = importlib.import_module("repro_torch.kernels.paged_attention")
K3 = importlib.import_module("repro_torch.kernels.flash_attention")


def _cdiv(a, b):
    return -(-a // b)
CAPACITIES = [(1, 8), (2, 8), (8, 8), (4, 16), (8, 64), (32, 16), (32, 64)]
HEAD_DIMS = (8, 16, 32, 64, 128)


def _check_k2_plan(p, B, Hkv, max_pages, page, sms):
    """What the CUDA side requires of a split plan (``run`` returns an error
    otherwise) and what makes it the right one."""
    cap = max_pages * page
    # the splits of a (sequence, KV head) form one cluster, no larger than
    # a non-portable cluster's 16
    assert 1 <= p.n_split <= K2.CLUSTER_MAX and p.c_min >= 1
    assert p.blocks == B * Hkv * p.n_split
    # no split that the capacity leaves without c_min slots
    assert p.n_split <= max(1, _cdiv(cap, p.c_min))
    # at least one wave of blocks, unless the capacity or one cluster caps
    # the split
    assert (p.blocks >= sms or p.n_split == _cdiv(cap, p.c_min)
            or p.n_split == K2.CLUSTER_MAX)


@pytest.mark.parametrize("sms", [114, 132])
@pytest.mark.parametrize("max_pages,page", CAPACITIES)
@pytest.mark.parametrize("Hkv", [1, 2, 8])
@pytest.mark.parametrize("B", [1, 3, 4, 8])
def test_k2_split_fills_a_wave(B, Hkv, max_pages, page, sms):
    """Capacities of 8 to 2048 rows: the split follows the card's SM
    count and fills a wave wherever the capacity and a cluster allow."""
    p = K2._plan(B, Hkv, max_pages, page, 128, torch.float32, sms)
    _check_k2_plan(p, B, Hkv, max_pages, page, sms)


@pytest.mark.parametrize("B,n_split", [(1, 16), (2, 16), (3, 8), (4, 8),
                                       (8, 4)])
def test_k2_main_shapes(B, n_split):
    """The executor's decode views at Llama-3-8B widths (8 KV heads, 64-row
    pages over a 512-row cache): about two waves of blocks, merged in one
    cluster.  At B = 1 a cluster of 16 (128 blocks) stands in for a wave."""
    p = K2._plan(B, 8, 8, 64, 128, torch.float32, SMS)
    _check_k2_plan(p, B, 8, 8, 64, SMS)
    assert p.n_split == n_split


@pytest.mark.parametrize("B,Hkv,max_pages,page,n_split", [
    (1, 1, 32, 64, 16), (1, 2, 32, 64, 16), (64, 8, 8, 64, 1),
    (1, 8, 1, 16, 1), (1, 8, 1, 17, 2)])
def test_k2_split_stops_at_one_cluster(B, Hkv, max_pages, page, n_split):
    """A 2048-row cache over one or two KV heads would want 128 or 64
    splits for two waves; the split stops at one cluster of 16.  Where the
    batch alone fills two waves, or the capacity holds one ``SPLIT_TILE``,
    each (sequence, KV head) is one block, a cluster of one."""
    p = K2._plan(B, Hkv, max_pages, page, 128, torch.float32, SMS)
    _check_k2_plan(p, B, Hkv, max_pages, page, SMS)
    assert p.n_split == n_split


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_k2_head_dims(d, dtype):
    p = K2._plan(4, 8, 8, 64, d, dtype, SMS)
    _check_k2_plan(p, 4, 8, 8, 64, SMS)
    with pytest.raises(ValueError):
        K2._plan(4, 8, 8, 64, 96, dtype, SMS)


def test_k2_plan_rejects():
    with pytest.raises(TypeError):
        K2._plan(1, 8, 8, 64, 128, torch.float64, SMS)
    with pytest.raises(ValueError):
        K2._plan(0, 8, 8, 64, 128, torch.float32, SMS)


def _split_ranges(length, p, cap):
    """The kernel's slot ranges: [s·c, min((s+1)·c, len)) with
    c = ceil(len / n_split) rounded up to a multiple of c_min."""
    n = max(0, min(length, cap))
    c = max(1, _cdiv(_cdiv(n, p.n_split), p.c_min)) * p.c_min
    return [(min(s * c, n), min(min(s * c, n) + c, n))
            for s in range(p.n_split)]


@pytest.mark.parametrize("B,Hkv,max_pages,page", [(1, 8, 8, 64),
                                                  (4, 8, 8, 64),
                                                  (3, 2, 4, 8)])
def test_k2_split_ranges_cover_every_slot_once(B, Hkv, max_pages, page):
    """For every length up to the capacity the splits' ranges tile
    [0, len) in order, each a multiple of c_min but the last."""
    p = K2._plan(B, Hkv, max_pages, page, 32, torch.float32, SMS)
    cap = max_pages * page
    for n in range(cap + 2):
        ranges = _split_ranges(n, p, cap)
        covered = [s for a, b in ranges for s in range(a, b)]
        assert covered == list(range(min(n, cap)))
        assert all((b - a) % p.c_min == 0 for a, b in ranges
                   if b < min(n, cap))


# ---------------------------------------------------------------------------
# K3 flash_attention: warps, heads and query rows of a block
# ---------------------------------------------------------------------------

K3_T = [1, 15, 16, 17, 32, 64, 65, 512]


def _k3_rows(p, B, T, H, Hkv):
    """The (b, h, query row) triples the grid's warps cover, by the
    kernel's index arithmetic: grid (x, B·H/heads), each block one or (with
    balance) two groups of ``rows`` query rows; warp w takes head
    w % heads and query tile w // heads."""
    g, nqb = H // Hkv, _cdiv(T, p.rows)
    ng = g // p.heads
    grid_x = _cdiv(nqb, 2) if p.balance else nqb
    seen = []
    for y in range(B * H // p.heads):
        hk, b = (y // ng) % Hkv, y // (ng * Hkv)
        for x in range(grid_x):
            groups = [nqb - 1 - x] + ([x] if p.balance and 2 * x + 1 < nqb
                                       else [])
            for qb in groups:
                for w in range(p.warps):
                    h = hk * g + (y % ng) * p.heads + w % p.heads
                    q0w = qb * p.rows + (w // p.heads) * K3.WARP_ROWS
                    seen += [(b, h, t) for t in
                             range(q0w, min(q0w + K3.WARP_ROWS, T))]
    return seen, grid_x * (B * H // p.heads)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("g", [1, 4, 16])
@pytest.mark.parametrize("T", K3_T)
def test_k3_tiles_cover_every_query_row_once(T, g, dtype):
    Hkv = 2
    H = g * Hkv
    for S in sorted({T, 512}):
        p = K3._plan(1, T, S, H, Hkv, 128, dtype, SMS)
        assert p.warps in (1, 2, 4) and p.warps % p.heads == 0
        assert g % p.heads == 0 and p.rows == 16 * p.warps // p.heads
        assert p.bk == K3.KV_ROWS[dtype]
        seen, blocks = _k3_rows(p, 1, T, H, Hkv)
        assert sorted(seen) == [(0, h, t) for h in range(H)
                                for t in range(T)]
        assert p.blocks == blocks
        # no warp of a block sits past T for want of query tiles
        assert p.warps == 1 or p.rows // 16 <= _cdiv(T, 16)


@pytest.mark.parametrize("sms", [114, 132])
@pytest.mark.parametrize("T", K3_T)
def test_k3_balance_follows_the_sm_count(T, sms):
    """Blocks take two row groups each exactly where the grid would hold
    more blocks than the card has SMs (so that an SM runs several)."""
    p = K3._plan(1, T, 512, 32, 8, 128, torch.float32, sms)
    nqb = _cdiv(T, p.rows)
    assert p.balance == (8 * nqb > sms and nqb > 1)
    assert p.blocks == 8 * (_cdiv(nqb, 2) if p.balance else nqb)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_k3_head_dims_fit_shared_memory(d, dtype):
    """Every tile fits the 227 KB a block may take; K's row stride is
    padded past the mma's K depth (d = 8 in bf16 rounds up to 16)."""
    for T in (1, 64, 512):
        p = K3._plan(1, T, 512, 32, 8, d, dtype, SMS)
        assert p.smem <= 232448
        ldk, ldv = K3._tile_strides(d, dtype)
        assert ldk >= max(d, K3._KSTEP[dtype]) and ldv >= d
        assert (ldk * dtype.itemsize) % 16 == 0
        assert (ldv * dtype.itemsize) % 16 == 0


def test_k3_main_shapes():
    """Phase 5's prompts (32, 64 tokens) and a 512-token one at Llama-3-8B
    widths: four warps on one KV head's four query heads; the 512-token
    prompt's 256 blocks are paired into 128."""
    for T, blocks in ((32, 16), (64, 32), (512, 128)):
        p = K3._plan(1, T, 512, 32, 8, 128, torch.float32, SMS)
        assert (p.warps, p.heads, p.rows) == (4, 4, 16)
        assert p.blocks == blocks and p.balance == (T == 512)


def test_k3_plan_rejects():
    with pytest.raises(TypeError):
        K3._plan(1, 4, 4, 4, 2, 32, torch.float64, SMS)
    with pytest.raises(ValueError):
        K3._plan(1, 4, 4, 4, 2, 96, torch.float32, SMS)
    with pytest.raises(ValueError):
        K3._plan(1, 0, 4, 4, 2, 32, torch.float32, SMS)
