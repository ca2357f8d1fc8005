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


# ---------------------------------------------------------------------------
# paged_attention (K2) and flash_attention (K3)
# ---------------------------------------------------------------------------
#
# The port's plain versions against the Pallas kernels in interpret mode and
# the JAX oracles, at the sweeps of tests/test_kernels.py (same tolerances).
# The kernels' own skip semantics (unmapped pages, length 0) differ from the
# oracles' and are held on the card in tests/test_torch_gpu.py.

from repro_torch.kernels import flash_attention, paged_attention  # noqa: E402


def _paged_inputs(lens, seed):
    """The sweep of tests/test_kernels.py: B=3, H=8, Hkv=2, d=32, pages of 8
    in a pool of 16, 4 pages per sequence, every page below a length
    mapped (in shuffled pool order) and the rest -1."""
    B, H, Hkv, d, page, P, MP = 3, 8, 2, 32, 8, 16, 4
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    kp = rng.standard_normal((P, page, Hkv, d)).astype(np.float32)
    vp = rng.standard_normal((P, page, Hkv, d)).astype(np.float32)
    pt = np.full((B, MP), -1, np.int32)
    used = iter(rng.permutation(P))
    for b in range(B):
        for i in range(-(-lens[b] // page)):
            pt[b, i] = next(used)
    return q, kp, vp, pt, np.asarray(lens, np.int32)


@pytest.mark.parametrize("lens", [[5, 17, 32], [1, 1, 1], [32, 8, 24]])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_paged_attention_matches_pallas_kernel(lens, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, kp, vp, pt, ln = _paged_inputs(lens, seed=sum(lens))
    j = [jnp.asarray(a, jdt) for a in (q, kp, vp)]
    want_kernel = jops.paged_attention(*j, jnp.asarray(pt), jnp.asarray(ln),
                                       interpret=True)
    want_ref = jref.paged_attention(*j, jnp.asarray(pt), jnp.asarray(ln))
    got = paged_attention(*(torch.from_numpy(a).to(tdt) for a in (q, kp, vp)),
                          torch.from_numpy(pt), torch.from_numpy(ln))
    assert got.dtype == tdt and got.shape == q.shape
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def _flash_inputs(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_q).astype(np.float32),
            rng.standard_normal(shape_kv).astype(np.float32),
            rng.standard_normal(shape_kv).astype(np.float32))


@pytest.mark.parametrize("T,S,d,causal", [
    (32, 32, 16, True), (64, 64, 32, True), (32, 64, 16, False),
    (128, 128, 64, True)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_flash_attention_matches_pallas_kernel(T, S, d, causal, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _flash_inputs((2, 2, T, d), (2, 2, S, d), seed=T + S + d)
    j = [jnp.asarray(a, jdt) for a in (q, k, v)]
    want_kernel = jops.flash_attention(*j, causal=causal, bq=16, bk=16,
                                       interpret=True)
    want_ref = jref.flash_attention(*j, causal=causal)
    got = flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                          causal=causal)
    assert got.dtype == tdt and got.shape == q.shape
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("T,S", [(17, 17), (5, 40)])
def test_plain_flash_attention_groups_kv_heads(T, S):
    """Hkv < H: query head h reads KV head h // (H/Hkv), as the oracle over
    ``jnp.repeat``-ed k/v; ragged T < S with the top-left causal mask."""
    H, Hkv, d = 8, 2, 16
    q, k, v = _flash_inputs((1, H, T, d), (1, Hkv, S, d), seed=T * S)
    want = jref.flash_attention(jnp.asarray(q),
                                jnp.repeat(jnp.asarray(k), H // Hkv, axis=1),
                                jnp.repeat(jnp.asarray(v), H // Hkv, axis=1),
                                causal=True)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def _masked_softmax_attention(q, k, v, q_offset):
    """Attention written out one query row at a time: row t of head h
    softmaxes its scores over keys 0 .. t + q_offset of KV head h // g."""
    B, H, T, d = q.shape
    g = H // k.shape[1]
    out = np.zeros_like(q)
    for b in range(B):
        for h in range(H):
            for t in range(T):
                n = t + q_offset + 1
                s = k[b, h // g, :n] @ q[b, h, t] / np.sqrt(d)
                p = np.exp(s - s.max())
                out[b, h, t] = (p / p.sum()) @ v[b, h // g, :n]
    return out


@pytest.mark.parametrize("T,S,q_offset", [
    (3, 40, 1), (4, 40, 15), (5, 40, 31), (7, 40, 33), (6, 40, 34),
    (17, 48, 16), (1, 9, 8)])
def test_plain_flash_attention_with_query_offset(T, S, q_offset):
    """The suffix prefill's mask: query row t sees keys s <= t + q_offset
    (offsets inside and on the edges of a 32-row K/V tile, and the last
    rows of the cache, q_offset = S - T), Hkv < H."""
    H, Hkv, d = 4, 2, 16
    q, k, v = _flash_inputs((2, H, T, d), (2, Hkv, S, d), seed=T + q_offset)
    calls = flash_attention.calls
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          q_offset=q_offset)
    assert flash_attention.calls == calls + 1
    np.testing.assert_allclose(got.numpy(),
                               _masked_softmax_attention(q, k, v, q_offset),
                               rtol=2e-5, atol=2e-5)
    # the plain version at offset 0 is the top-left aligned mask
    q0 = torch.from_numpy(q)
    kv = [torch.from_numpy(a) for a in (k, v)]
    np.testing.assert_allclose(
        ref.flash_attention(q0, *kv, q_offset=0).numpy(),
        _masked_softmax_attention(q, k, v, 0), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("q_offset", [-1, 4])
def test_flash_attention_rejects_rows_outside_the_keys(q_offset):
    """0 <= q_offset and q_offset + T <= S (here T = 6, S = 9)."""
    args = [torch.from_numpy(a) for a in
            _flash_inputs((1, 4, 6, 8), (1, 2, 9, 8), 0)]
    calls = flash_attention.calls
    with pytest.raises(ValueError, match="outside"):
        flash_attention(*args, q_offset=q_offset)
    assert flash_attention.calls == calls


@pytest.mark.parametrize("kernel", ["paged", "flash"])
def test_attention_cpu_tensors_take_the_plain_version(kernel):
    if kernel == "paged":
        fn, plain = paged_attention, ref.paged_attention
        args = [torch.from_numpy(a) for a in _paged_inputs([5, 9, 1], 0)]
    else:
        fn, plain = flash_attention, ref.flash_attention
        args = [torch.from_numpy(a) for a in
                _flash_inputs((1, 4, 6, 8), (1, 2, 9, 8), 0)]
    calls, launches = fn.calls, fn.launches
    got = fn(*args)
    assert fn.calls == calls + 1 and fn.launches == launches
    assert torch.equal(got, plain(*args))


def _bad_attention_args(kernel, case):
    """Arguments with one defect each (the rest well formed)."""
    if kernel == "paged":
        q, kp, vp = torch.ones(2, 4, 8), torch.ones(3, 4, 2, 8), \
            torch.ones(3, 4, 2, 8)
        pt, ln = torch.zeros(2, 2, dtype=torch.int32), torch.ones(2).long()
        args = [q, kp, vp, pt, ln]
        bad = {"rank": (0, torch.ones(2, 4, 8, 1)),
               "dtype": (0, q.double()),
               "mixed_dtype": (1, kp.bfloat16()),
               "mixed_device": (1, torch.ones(3, 4, 2, 8, device="meta")),
               "inner_stride": (0, torch.ones(2, 8, 4).transpose(1, 2)),
               "heads": (0, torch.ones(2, 3, 8)),
               "index_dtype": (4, ln.float())}
    else:
        q, k = torch.ones(1, 4, 6, 8), torch.ones(1, 2, 9, 8)
        args = [q, k, k.clone()]
        bad = {"rank": (0, torch.ones(4, 6, 8)),
               "dtype": (0, q.double()),
               "mixed_dtype": (2, k.bfloat16()),
               "mixed_device": (1, torch.ones(1, 2, 9, 8, device="meta")),
               "inner_stride": (0, torch.ones(1, 4, 8, 6).transpose(2, 3)),
               "heads": (0, torch.ones(1, 3, 6, 8))}
    i, t = bad[case]
    args[i] = t
    return args


_DEFECTS = ("rank", "dtype", "mixed_dtype", "mixed_device", "inner_stride",
            "heads")


@pytest.mark.parametrize("kernel,case", [
    (k, c) for k in ("paged", "flash") for c in _DEFECTS]
    + [("paged", "index_dtype")])
def test_attention_wrappers_reject(kernel, case):
    args = _bad_attention_args(kernel, case)
    fn = paged_attention if kernel == "paged" else flash_attention
    calls = fn.calls
    with pytest.raises((ValueError, TypeError)):
        fn(*args)
    assert fn.calls == calls


# ---------------------------------------------------------------------------
# K2's split-K flash-decoding, modelled on the CPU
# ---------------------------------------------------------------------------
#
# The CUDA kernel splits each (sequence, KV head) over ``_plan``'s n_split
# blocks, each taking the slots [s·c, min((s+1)·c, len)) with
# c = ceil(len / n_split) rounded up to a multiple of c_min, skipping
# unmapped pages, and merges the blocks' (max, sum, accumulator) states in
# split order; an empty split's state (max −∞, sum 0) weighs nothing.  The
# model below does the same arithmetic in plain torch, so the ranges, the
# empty-split rule and the merge are held against the Pallas kernel here,
# where no card is.

import importlib  # noqa: E402

_K2 = importlib.import_module("repro_torch.kernels.paged_attention")


def _cdiv(a, b):
    return -(-a // b)


def _split_model(q, kp, vp, pt, lens, plan):
    B, H, d = q.shape
    page, Hkv = kp.shape[1], kp.shape[2]
    g, cap = H // Hkv, pt.shape[1] * page
    out = torch.zeros(B, H, d)
    for b in range(B):
        n = max(0, min(int(lens[b]), cap))
        c = max(1, _cdiv(_cdiv(n, plan.n_split), plan.c_min)) * plan.c_min
        for hk in range(Hkv):
            qg = q[b, hk * g:(hk + 1) * g].float()
            ms, ls, accs = [], [], []
            for s in range(plan.n_split):
                a0 = min(s * c, n)
                slots = [t for t in range(a0, min(a0 + c, n))
                         if pt[b, t // page] >= 0]
                if not slots:  # the empty state
                    ms.append(torch.full((g,), -torch.inf))
                    ls.append(torch.zeros(g))
                    accs.append(torch.zeros(g, d))
                    continue
                rows = [(int(pt[b, t // page]), t % page) for t in slots]
                k = torch.stack([kp[p, o, hk] for p, o in rows]).float()
                v = torch.stack([vp[p, o, hk] for p, o in rows])
                sc = qg @ k.T / d ** 0.5
                m = sc.max(-1).values
                p = torch.exp(sc - m[:, None])
                ms.append(m)
                ls.append(p.sum(-1))
                accs.append(p.to(v.dtype).float() @ v.float())
            mm = torch.stack(ms).max(0).values
            w = [torch.where(m == -torch.inf, 0.0, torch.exp(m - mm))
                 for m in ms]
            lsum = sum(wi * li for wi, li in zip(w, ls))
            acc = sum(wi[:, None] * ai for wi, ai in zip(w, accs))
            out[b, hk * g:(hk + 1) * g] = acc / lsum.clamp_min(1e-30)[:, None]
    return out.to(q.dtype)


def _split_inputs(lens, seed):
    """B = len(lens), H 8, Hkv 2, d 32, pages of 8, 8 pages a sequence
    (capacity 64) in a pool of 20, mapped in shuffled order."""
    B, H, Hkv, d, page, P, MP = len(lens), 8, 2, 32, 8, 20, 8
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    kp = rng.standard_normal((P, page, Hkv, d)).astype(np.float32)
    vp = rng.standard_normal((P, page, Hkv, d)).astype(np.float32)
    pt = np.full((B, MP), -1, np.int32)
    used = iter(rng.permutation(P))
    for b in range(B):
        for i in range(_cdiv(lens[b], page)):
            pt[b, i] = next(used)
    return q, kp, vp, pt, np.asarray(lens, np.int32)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 64])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_split_model_matches_pallas_kernel(n, dtype):
    """Lengths 0, 1, page − 1, page, page + 1 and the capacity, beside a
    33-row sequence: four splits of 16 slots, so the short lengths leave
    splits empty."""
    jdt, tdt, tol = DTYPES[dtype]
    q, kp, vp, pt, ln = _split_inputs([n, 33], seed=n)
    plan = _K2._plan(2, 2, pt.shape[1], 8, 32, tdt, 132)
    assert plan.n_split == 4 and plan.c_min == 16
    want = jops.paged_attention(*(jnp.asarray(a, jdt) for a in (q, kp, vp)),
                                jnp.asarray(pt), jnp.asarray(ln),
                                interpret=True)
    got = _split_model(*(torch.from_numpy(a).to(tdt) for a in (q, kp, vp)),
                       torch.from_numpy(pt), torch.from_numpy(ln), plan)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    if n == 0:
        assert not got[0].any()


def test_split_model_skips_an_unmapped_page():
    """Sequence 0 (length 20, pages of 8) without its page 1: the model
    skips it, as the CUDA kernel does, and equals the Pallas kernel over
    the table without that page (length 12).  (The Pallas kernel itself
    reads pool page 0 for an unmapped entry: its wrapper hands the kernel
    the table with -1 replaced by 0.)"""
    q, kp, vp, pt, ln = _split_inputs([20, 33], seed=5)
    holed = pt.copy()
    holed[0, 1] = -1
    compact = pt.copy()
    compact[0, 1:] = np.append(pt[0, 2:], -1)
    plan = _K2._plan(2, 2, pt.shape[1], 8, 32, torch.float32, 132)
    got = _split_model(*(torch.from_numpy(a) for a in (q, kp, vp)),
                       torch.from_numpy(holed), torch.from_numpy(ln), plan)
    want = jops.paged_attention(*(jnp.asarray(a) for a in (q, kp, vp)),
                                jnp.asarray(compact),
                                jnp.asarray(np.array([12, 33], np.int32)),
                                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# the planner's layouts: K1 over column tables, K2/K3 over each cache order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("H,K,Nh,M", [(1, 40, 24, 3), (4, 32, 8, 5),
                                      (1, 7, 5, 1), (3, 16, 32, 33)])
def test_plain_column_layouts_equal_the_row_layout(H, K, Nh, M):
    """A COL_CHUNK (H = 1) or COL_CHUNK_HEADS table is the row weight
    transposed per head: the plain K1 in the column layout gives X·Wᵀ."""
    rng = np.random.default_rng(H * K + Nh)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((H * Nh, K)).astype(np.float32))
    w_col = w.reshape(H, Nh, K).transpose(1, 2).contiguous()
    calls = chunked_matmul.calls
    got = chunked_matmul(x, w_col, layout="col")
    assert chunked_matmul.calls == calls + 1
    torch.testing.assert_close(got, ref.chunked_matmul(x, w), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("case", [
    ((2, 8), (8, 4), {"layout": "col"}),          # col needs a 3-D w
    ((2, 8), (1, 4, 8), {"layout": "col"}),       # K mismatch
    ((2, 8), (4, 8), {"layout": "nn"}),           # unknown layout
    ((2, 8), (1, 8, 4), {}),                      # row needs a 2-D w
])
def test_column_layout_rejects(case):
    xs, ws, kw = case
    with pytest.raises(ValueError):
        chunked_matmul(torch.ones(xs), torch.ones(ws), **kw)


def _cache_views(order, data):
    """``data`` [(B,) S, Hkv, nc, cs] stored in a planner key order and
    viewed back as the executor views it: the K2 pool (one page a
    sequence outside the row order) and K3's heads-first rows."""
    from repro_torch.core.executor import DenseTable, permute_table_keys
    from repro_torch.core.relational import VEC
    B, S, Hkv, nc, cs = data.shape
    keys = (("seq", B), ("tp", S), ("hk", Hkv), ("c", nc))
    t = DenseTable(keys=keys, cols={"kv": data}, col_types={"kv": VEC(cs)})
    stored = permute_table_keys(t, ("seq",) + order)
    stored.cols["kv"] = stored.cols["kv"].contiguous()
    seen = permute_table_keys(stored, ("seq", "tp", "hk", "c")).cols["kv"]
    return seen.reshape(B, S, Hkv, nc * cs)


@pytest.mark.parametrize("order", [("tp", "hk", "c"), ("hk", "tp", "c"),
                                   ("tp", "c", "hk")])
def test_plain_attention_over_every_cache_order(order):
    """K2 and K3's plain versions over caches stored head_major or
    pos_major (viewed, or gathered, back into rows) equal the row-order
    result."""
    rng = np.random.default_rng(len(order[0]))
    B, S, Hkv, nc, cs, H = 2, 12, 2, 2, 4, 4
    k = torch.from_numpy(rng.standard_normal((B, S, Hkv, nc, cs)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, Hkv, nc, cs)).astype(
        np.float32))
    q = torch.from_numpy(rng.standard_normal((B, H, nc * cs)).astype(
        np.float32))
    rows_k, rows_v = k.reshape(B, S, Hkv, -1), v.reshape(B, S, Hkv, -1)
    vk, vv = _cache_views(order, k), _cache_views(order, v)
    lengths = torch.tensor([5, 12])
    pt = torch.arange(B).reshape(B, 1)
    want = paged_attention(q, rows_k, rows_v, pt, lengths)
    torch.testing.assert_close(paged_attention(q, vk, vv, pt, lengths), want)
    qf = torch.from_numpy(rng.standard_normal((1, H, 3, nc * cs)).astype(
        np.float32))
    want = flash_attention(qf, rows_k[:1].transpose(1, 2),
                           rows_v[:1].transpose(1, 2), q_offset=4)
    torch.testing.assert_close(
        flash_attention(qf, vk[:1].transpose(1, 2), vv[:1].transpose(1, 2),
                        q_offset=4), want)
