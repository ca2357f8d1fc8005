"""The port's paged KV cache against the JAX package's.

``PagedKVCache`` in both packages takes the same appends (numpy from a
seed) in both page layouts; the pools, page tables, gathers and kernel
views must agree exactly.  Then the port's plain paged attention over
``kernel_views`` + ``batch_views`` must equal attention over the
contiguous sequence (float32, within 2e-5 as ``tests/test_kernels.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.serving.kvcache import (PagedKVCache as JPaged,  # noqa: E402
                                   PagedKVConfig as JConfig)
from repro_torch.kernels import paged_attention, ref  # noqa: E402
from repro_torch.serving.kvcache import (PagedKVCache,  # noqa: E402
                                         PagedKVConfig)

CFG = dict(n_layers=2, n_kv=2, head_dim=4, page_size=4, n_pages=8,
           max_pages_per_seq=4)
LAYOUTS = ["row_chunk", "head_major"]


def _caches(layout, max_seqs=3, **over):
    cfg = dict(CFG, layout=layout, **over)
    return (JPaged(JConfig(**cfg), max_seqs=max_seqs),
            PagedKVCache(PagedKVConfig(**cfg), max_seqs=max_seqs,
                         device="cpu"))


def _rows(n, seed, cfg=CFG):
    return np.random.default_rng(seed).standard_normal(
        (n, cfg["n_layers"], cfg["n_kv"], cfg["head_dim"])).astype(np.float32)


def _append_both(jkv, tkv, seq, rows, start=0):
    for i, r in enumerate(rows):
        jkv.append(seq, jnp.asarray(r), jnp.asarray(r * 2), start + i)
        tkv.append(seq, torch.from_numpy(r), torch.from_numpy(r * 2),
                   start + i)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_append_gather_roundtrip_matches_jax(layout):
    jkv, tkv = _caches(layout)
    assert tuple(tkv.k_pool.shape) == jkv.k_pool.shape
    for s in (0, 1):
        jkv.allocate_seq(s)
        tkv.allocate_seq(s)
    ks = _rows(6, seed=0)
    _append_both(jkv, tkv, 0, ks)
    _append_both(jkv, tkv, 1, _rows(3, seed=1))
    np.testing.assert_array_equal(tkv.page_table, jkv.page_table)
    np.testing.assert_array_equal(tkv.seq_lens, jkv.seq_lens)
    np.testing.assert_array_equal(tkv.k_pool.numpy(), np.asarray(jkv.k_pool))
    np.testing.assert_array_equal(tkv.v_pool.numpy(), np.asarray(jkv.v_pool))
    k, v, T = tkv.gather(0, layer=1)
    jk, jv, jT = jkv.gather(0, layer=1)
    assert T == jT == 6
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(k.numpy(), ks[:, 1])
    np.testing.assert_array_equal(v.numpy(), ks[:, 1] * 2)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_kernel_views_match_jax(layout):
    """Kernel consumers get the slot-major order whatever the layout; for
    head_major the port's view is a transpose, not a copy."""
    jkv, tkv = _caches(layout)
    jkv.allocate_seq(0)
    tkv.allocate_seq(0)
    ks = _rows(6, seed=2)
    _append_both(jkv, tkv, 0, ks)
    for layer in range(CFG["n_layers"]):
        kk, vk = tkv.kernel_views(layer)
        jk, jv = jkv.kernel_views(layer)
        assert tuple(kk.shape) == (CFG["n_pages"], CFG["page_size"],
                                   CFG["n_kv"], CFG["head_dim"])
        assert kk.data_ptr() == tkv.k_pool[layer].data_ptr()
        np.testing.assert_array_equal(kk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(vk.numpy(), np.asarray(jv))
    page0 = int(tkv.page_table[0, 0])
    np.testing.assert_array_equal(tkv.kernel_views(1)[0][page0].numpy(),
                                  ks[:4, 1])


def test_batch_views_match_jax():
    jkv, tkv = _caches("row_chunk")
    for s, n in ((0, 6), (2, 3)):
        jkv.allocate_seq(s)
        tkv.allocate_seq(s)
        _append_both(jkv, tkv, s, _rows(n, seed=s))
    pt, lens = tkv.batch_views([2, 0])
    jpt, jlens = jkv.batch_views([2, 0])
    assert pt.dtype == lens.dtype == torch.int64
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jpt))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))


def test_unknown_layout_rejected():
    with pytest.raises(ValueError):
        PagedKVCache(PagedKVConfig(n_layers=1, n_kv=1, head_dim=4,
                                   layout="bogus"), max_seqs=1, device="cpu")


def test_page_reuse_after_free():
    jkv, tkv = _caches("row_chunk")
    for kv in (jkv, tkv):
        kv.allocate_seq(0)
        kv.ensure_capacity(0, 16)  # all 4 pages
    free_before = tkv.free_page_count()
    assert free_before == jkv.free_page_count()
    for kv in (jkv, tkv):
        kv.free_seq(0)
    assert tkv.free_page_count() == jkv.free_page_count() == free_before + 4


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_pool_exhaustion_raises(pkg):
    kv = _caches("row_chunk", max_seqs=3, n_pages=4)[pkg == "torch"]
    kv.allocate_seq(0)
    kv.ensure_capacity(0, 16)
    kv.allocate_seq(1)
    with pytest.raises(RuntimeError, match="exhausted"):
        kv.ensure_capacity(1, 1)
    with pytest.raises(RuntimeError, match="max_pages_per_seq"):
        kv.ensure_capacity(0, 17)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_paged_attention_over_views_matches_dense_attention(layout):
    """The idea of tests/test_kernels.py::test_matches_dense_attention on
    the port's cache: two sequences appended token by token into shuffled
    pool pages, then the plain K2 over ``kernel_views`` + ``batch_views``
    equals full attention of one query over each contiguous sequence
    (JAX's oracle and the port's plain flash attention, k/v heads
    grouped)."""
    H, Hkv, d, page, T = 4, 2, 16, 4, (12, 7)
    cfg = dict(n_layers=1, n_kv=Hkv, head_dim=d, page_size=page, n_pages=8,
               max_pages_per_seq=4, layout=layout)
    kv = PagedKVCache(PagedKVConfig(**cfg), max_seqs=2, device="cpu")
    kv._free = list(np.random.default_rng(0).permutation(8))  # scatter pages
    rng = np.random.default_rng(1)
    seqs = [rng.standard_normal((2, n, Hkv, d)).astype(np.float32)
            for n in T]
    for b, (k, v) in enumerate(seqs):
        kv.allocate_seq(b)
        for pos in range(k.shape[0]):
            kv.append(b, torch.from_numpy(k[pos][None]),
                      torch.from_numpy(v[pos][None]), pos)
    q = rng.standard_normal((2, H, d)).astype(np.float32)
    calls = paged_attention.calls
    got = paged_attention(torch.from_numpy(q), *kv.kernel_views(0),
                          *kv.batch_views([0, 1]))
    assert paged_attention.calls == calls + 1
    for b, (k, v) in enumerate(seqs):
        kk = jnp.repeat(jnp.asarray(k).transpose(1, 0, 2)[None], H // Hkv,
                        axis=1)
        vv = jnp.repeat(jnp.asarray(v).transpose(1, 0, 2)[None], H // Hkv,
                        axis=1)
        want = jref.flash_attention(jnp.asarray(q[b])[None, :, None, :], kk,
                                    vv, causal=False)[0, :, 0]
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
        plain = ref.flash_attention(
            torch.from_numpy(q[b])[None, :, None, :],
            torch.from_numpy(k).permute(1, 0, 2)[None],
            torch.from_numpy(v).permute(1, 0, 2)[None], causal=False)
        np.testing.assert_allclose(got[b].numpy(), plain[0, :, 0].numpy(),
                                   rtol=2e-5, atol=2e-5)
