"""The port's prefix cache, suffix prefill and serving metrics against the
JAX package's.

Both packages run the same numpy weights (the port on the CPU, where
``flash_attention`` and ``paged_attention`` take their plain versions; the
JAX engine unplanned, the configuration the port implements).  A
prefix-hit decoder must generate exactly the tokens of the JAX package's
prefix-hit decoder and of a cold decoder, suffix-session logits agree
within 1e-5, and every segment tensor stays bit-unchanged while sequences
share it (the port's cache writes are in place where the reference's are
functional).  The metrics registry is a copy of the reference's; its
tests run against both registries.
"""

import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.llama_graph import LlamaSpec as JSpec  # noqa: E402
from repro.core.llama_graph import init_llama_params  # noqa: E402
from repro.obs.metrics import MetricsRegistry as JRegistry  # noqa: E402
from repro.serving.engine import RelationalEngine as JEngine  # noqa: E402
from repro.serving.kvcache import BatchedCacheTables as JPool  # noqa: E402
from repro.serving.kvcache import CacheSegment as JSegment  # noqa: E402
from repro.serving.kvcache import PrefixCache as JPrefixCache  # noqa: E402
from repro.serving.kvcache import PagedKVCache as JPaged  # noqa: E402
from repro.serving.kvcache import PagedKVConfig as JPagedCfg  # noqa: E402
from repro.serving.scheduler import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro_torch.core.llama_graph import LlamaSpec  # noqa: E402
from repro_torch.kernels import flash_attention, paged_attention  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.serving.engine import RelationalEngine  # noqa: E402
from repro_torch.serving.kvcache import (BatchedCacheTables,  # noqa: E402
                                         CacheSegment, PagedKVCache,
                                         PagedKVConfig, PrefixCache)
from repro_torch.serving.scheduler import (ContinuousBatcher,  # noqa: E402
                                           Request)

SPEC_ARGS = dict(vocab=64, d_model=32, n_layers=1, n_heads=4, n_kv=2,
                 d_ff=64, rope_theta=10000.0)
PARAMS = init_llama_params(JSpec(**SPEC_ARGS), seed=3)
PREFIX = [5, 9, 2, 7, 11, 4, 6, 8]   # two full hash blocks (block=4)
REGISTRIES = [pytest.param(JRegistry, id="jax"),
              pytest.param(MetricsRegistry, id="port")]
_ENGINES = {}


def _engines(cs=8, max_len=24):
    """(JAX engine, port engine) over the same weights, built once."""
    key = (cs, max_len)
    if key not in _ENGINES:
        _ENGINES[key] = (
            JEngine(JSpec(**SPEC_ARGS), PARAMS, chunk_size=cs,
                    max_len=max_len, row2col="off", cache_layout="off"),
            RelationalEngine(LlamaSpec(**SPEC_ARGS), PARAMS, chunk_size=cs,
                             max_len=max_len, device="cpu"))
    return _ENGINES[key]


def _decode_n(dec, sid, tok, n):
    toks = [tok]
    for _ in range(n - 1):
        tok = dec.decode([sid], [tok])[0]
        toks.append(tok)
    return toks


def _segment_snapshot(pc):
    """Clones of every tensor of every live segment, keyed by identity."""
    return {(id(seg), name): t.cols[c].clone()
            for seg in pc._segments for name, t in seg.tables.items()
            for c in t.cols}


def _segments_unchanged(pc, snap):
    now = {(id(seg), name): t.cols[c]
           for seg in pc._segments for name, t in seg.tables.items()
           for c in t.cols}
    return all(torch.equal(now[k], v) for k, v in snap.items() if k in now)


# ---------------------------------------------------------------------------
# suffix sessions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cs", [4, 8])
@pytest.mark.parametrize("tail", [[1], [1, 2, 3], [3, 1, 4, 1, 5, 9]])
def test_suffix_session_matches_jax(cs, tail):
    """``start_suffix_session`` over a prefix session's caches: logits
    within 1e-5 of the JAX package's, equal to a cold session's within
    1e-5, the prefix caches untouched; the attention runs on K3 with
    ``q_offset = 8`` for a suffix of T > 1 tokens and on K2 for one."""
    je, te = _engines(cs)
    prompt = PREFIX + tail
    jtab = {k: v for k, v in je.start_session(PREFIX)["env"].items()
            if k.startswith(("k_cache", "v_cache"))}
    ttab = {k: v for k, v in te.start_session(PREFIX)["env"].items()
            if k.startswith(("k_cache", "v_cache"))}
    snap = {k: v.cols["kv" if "k_cache" in k else "vv"].clone()
            for k, v in ttab.items()}
    k2, k3 = paged_attention.calls, flash_attention.calls
    got = te.start_suffix_session(prompt, len(PREFIX), ttab)
    one = len(tail) == 1
    assert (paged_attention.calls - k2, flash_attention.calls - k3) == (
        (1, 0) if one else (0, 1))
    want = je.start_suffix_session(prompt, len(PREFIX), jtab)
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-5,
                               atol=1e-5)
    assert got["tok"] == want["tok"] and got["pos"] == len(prompt)
    np.testing.assert_allclose(got["logits"],
                               te.start_session(prompt)["logits"],
                               rtol=1e-5, atol=1e-5)
    assert all(torch.equal(v, ttab[k].cols["kv" if "k_cache" in k else "vv"])
               for k, v in snap.items())


def test_suffix_session_edge_cases():
    _, te = _engines()
    assert te.start_suffix_session([1, 2, 3], 0, {})["pos"] == 3
    with pytest.raises(ValueError, match="suffix prefill"):
        te.start_suffix_session(PREFIX, len(PREFIX), {})


# ---------------------------------------------------------------------------
# the reference's TestPrefixCachedDecode (tests/test_serving.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["copy", "share"])
def test_hit_decode_token_exact(mode):
    """Suffix-only prefill after a hit generates exactly the cold
    reference tokens and the JAX package's prefix-hit tokens."""
    je, te = _engines()
    p1 = PREFIX + [1, 2]
    p2 = PREFIX + [3]
    ref = te.generate(p2, max_new_tokens=4).tokens
    decs = [e.batched_decoder(max_seqs=2, prefix_block=4, prefix_bind=mode)
            for e in (je, te)]
    got = []
    for dec in decs:
        t0, c0 = dec.prefill_ex(p1, 0)      # cold: interns the segment
        assert c0 == 0
        t1, c1 = dec.prefill_ex(p2, 1)      # hit on the shared prefix
        assert c1 == len(PREFIX)
        got.append(_decode_n(dec, 1, t1, 4))
        pc = dec.prefix_cache
        assert pc.stats.hits == 1 and pc.stats.misses == 1
    assert got[1] == got[0] == ref


def test_shared_and_cold_slots_decode_together():
    """A share-bound slot (spliced segment rows) and a cold slot decode
    in the same batched tick, each against its own cache contents."""
    _, te = _engines()
    p_cold = [3, 4, 5, 6]
    p_hit = PREFIX + [1]
    ref_cold = te.generate(p_cold, max_new_tokens=4).tokens
    ref_hit = te.generate(p_hit, max_new_tokens=4).tokens
    dec = te.batched_decoder(max_seqs=3, prefix_block=4,
                             prefix_bind="share")
    dec.prefill_ex(PREFIX + [2], 2)        # intern the segment
    ta, ca = dec.prefill_ex(p_cold, 0)
    tb, cb = dec.prefill_ex(p_hit, 1)
    assert ca == 0 and cb == len(PREFIX)
    got_a, got_b = [ta], [tb]
    for _ in range(3):
        ta, tb = dec.decode([0, 1], [ta, tb])
        got_a.append(ta)
        got_b.append(tb)
    assert got_a == ref_cold
    assert got_b == ref_hit


def test_share_mode_refcounts_and_free():
    _, te = _engines()
    dec = te.batched_decoder(max_seqs=2, prefix_block=4,
                             prefix_bind="share")
    dec.prefill_ex(PREFIX + [1], 0)
    _, cached = dec.prefill_ex(PREFIX + [2], 1)
    assert cached == len(PREFIX)
    seg, boundary = dec.pool.bindings[1]
    assert boundary == len(PREFIX)
    assert seg.refcount == 1            # pinned by the binding
    dec.free(1)
    assert 1 not in dec.pool.bindings   # binding dropped with the slot
    assert seg.refcount == 0            # unpinned -> evictable


def test_eviction_skips_pinned_segments():
    _, te = _engines()
    pc = PrefixCache(block=4, max_segments=1)
    p1, p2 = [1, 2, 3, 4, 5], [6, 7, 8, 9, 10]
    seg1 = pc.insert(p1, te.start_session(p1)["env"])
    pc.acquire(seg1)                 # pinned by a share-mode binding
    pc.insert(p2, te.start_session(p2)["env"])
    # over budget: the dead newcomer is reclaimed at insert time; the
    # pinned segment never is (the pager's pinned-pages rule)
    assert pc.stats.evictions == 1 and len(pc._segments) == 1
    assert pc.lookup(p1) is not None
    assert pc.lookup(p2) is None


def test_release_unblocks_pending_eviction():
    _, te = _engines()
    pc = PrefixCache(block=4, max_segments=2)
    p1, p2 = [1, 2, 3, 4, 5], [6, 7, 8, 9, 10]
    seg1 = pc.insert(p1, te.start_session(p1)["env"])
    pc.acquire(seg1)
    seg2 = pc.insert(p2, te.start_session(p2)["env"])
    pc.acquire(seg2)
    pc.max_segments = 1              # budget shrinks under live load
    pc._evict()
    assert pc.stats.evictions == 0   # all pinned: transient overflow
    pc.release(seg1)
    # the release unblocks eviction of the now-dead LRU segment
    assert pc.stats.evictions == 1 and len(pc._segments) == 1
    assert pc.lookup(p2) is not None
    pc.release(seg2)
    assert len(pc._segments) == 1    # within budget: nothing more


def test_insert_dedupes_on_covered_prefix():
    _, te = _engines()
    pc = PrefixCache(block=4)
    p = PREFIX + [1]
    env = te.start_session(p)["env"]
    assert pc.insert(p, env) is not None
    assert pc.insert(p, env) is None    # same deepest block: skipped
    assert pc.stats.insertions == 1
    # nbytes: every element of the K and V tables, f32
    assert pc.resident_bytes == sum(
        t.cols[c].numel() * 4 for n, t in env.items()
        if n.startswith(("k_cache", "v_cache")) for c in t.cols)


def test_disabled_cache_falls_back_to_cold():
    _, te = _engines()
    ref = te.generate(PREFIX + [1], max_new_tokens=3).tokens
    dec = te.batched_decoder(max_seqs=1, prefix_block=0)
    assert dec.prefix_cache is None
    tok, cached = dec.prefill_ex(PREFIX + [1], 0)
    assert cached == 0
    assert _decode_n(dec, 0, tok, 3) == ref


def test_bind_mode_is_checked_and_auto_copies():
    _, te = _engines()
    with pytest.raises(ValueError, match="prefix_bind"):
        te.batched_decoder(2, prefix_bind="borrow")
    dec = te.batched_decoder(2, prefix_block=4)
    assert dec._resolve_bind(8) == "copy"   # no residency budget
    dec.prefill_ex(PREFIX + [1], 0)
    dec.prefill_ex(PREFIX + [2], 1)
    assert not dec.pool.bindings


def test_batched_cache_pool_roundtrip():
    """The reference's pool test (``tests/test_serving.py``): slot gather
    and bulk scatter are exact and leave other slots untouched; free
    resets the position; a refill overwrites the slot."""
    _, te = _engines()
    pool = BatchedCacheTables(te.spec, max_seqs=3, cache_len=te.max_len,
                              chunk_size=8, device="cpu")
    name = next(iter(pool.tables))
    cn = next(iter(pool.tables[name].cols))
    sess = te.start_session([5, 9, 2])
    pool.write_prefill(1, sess["env"], 3)
    assert pool.positions[1] == 3
    views = pool.gather_views([1])
    assert torch.equal(views[name].cols[cn][0], sess["env"][name].cols[cn])
    gen = pool.slot_generations([1])
    views[name].cols[cn] = views[name].cols[cn] + 1.0
    pool.scatter([1], views)
    assert pool.slot_generations([1]) != gen
    assert torch.equal(pool.tables[name].cols[cn][1],
                       sess["env"][name].cols[cn] + 1.0)
    assert not pool.tables[name].cols[cn][0].any()
    pool.free(1)
    assert pool.positions[1] == 0
    sess2 = te.start_session([7, 1])
    pool.write_prefill(1, sess2["env"], 2)
    assert torch.equal(pool.gather_views([1])[name].cols[cn][0],
                       sess2["env"][name].cols[cn])


def test_share_splice_matches_jax():
    """A share-bound slot's gathered view (segment rows below the boundary,
    the slot's own rows from it) equals the JAX pool's, with the slot
    repeated as bucket padding; the pool's own rows below the boundary
    and the segment stay as they were."""
    je, te = _engines()
    prompt = PREFIX + [1, 2, 3]
    views = []
    for eng, Pool, Segment, kw in (
            (je, JPool, JSegment, {}),
            (te, BatchedCacheTables, CacheSegment, {"device": "cpu"})):
        seg_env = eng.start_session(PREFIX)["env"]
        tables = {k: v for k, v in seg_env.items()
                  if k.startswith(("k_cache", "v_cache"))}
        sess = eng.start_suffix_session(prompt, len(PREFIX), tables)
        pool = Pool(eng.spec, 3, eng.max_len, 8, **kw)
        pool.write_suffix(1, sess["env"], len(prompt), len(PREFIX))
        pool.bind_segment(1, Segment(tuple(PREFIX), tables, 0), len(PREFIX))
        views.append(pool.gather_views([1, 0, 1]))
        if eng is te:
            name = "k_cache_L0"
            snap = tables[name].cols["kv"].clone()
            assert not pool.tables[name].cols["kv"][1, :len(PREFIX)].any()
            assert torch.equal(tables[name].cols["kv"], snap)
            assert torch.equal(views[-1][name].cols["kv"][0],
                               sess["env"][name].cols["kv"])
    for name, t in views[1].items():
        for c, arr in t.cols.items():
            np.testing.assert_allclose(arr.numpy(),
                                       np.asarray(views[0][name].cols[c]),
                                       rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# acceptance grid: hit decoders against JAX's and a cold decoder
# ---------------------------------------------------------------------------


def _prompts(B, seed):
    rng = np.random.default_rng(seed)
    return [PREFIX + [int(t) for t in rng.integers(0, 64, int(n))]
            for n in rng.integers(1, 4, B)]


@pytest.mark.parametrize("cs", [4, 8])
@pytest.mark.parametrize("B", [1, 2, 3])
@pytest.mark.parametrize("mode", ["copy", "share"])
def test_prefix_hit_decoders_match_jax_and_cold(mode, B, cs):
    """B sequences admit as prefix hits over one donor's segment (one of
    them, at B = 3, after the donor's slot is freed and re-filled): the
    port's tokens equal the JAX package's prefix-hit decoder's and the
    port's cold decoder's at every step, and the segments stay
    bit-unchanged."""
    je, te = _engines(cs)
    prompts = _prompts(B, seed=10 * B + cs)
    cold = te.batched_decoder(max_seqs=B, prefix_block=0)
    toks_c = [cold.prefill(p, i) for i, p in enumerate(prompts)]
    hots = [e.batched_decoder(max_seqs=B + 1, prefix_block=4,
                              prefix_bind=mode) for e in (je, te)]
    snap = None
    toks = []
    for hot in hots:
        hot.prefill_ex(PREFIX + [0], B)   # donor interns the segment
        hot.free(B)
        if hot is hots[1]:
            snap = _segment_snapshot(hot.prefix_cache)
        res = [hot.prefill_ex(p, i) for i, p in enumerate(prompts)]
        assert all(c == len(PREFIX) for _, c in res)
        toks.append([t for t, _ in res])
    assert toks[1] == toks[0] == toks_c
    ids = list(range(B))
    for _ in range(3):
        toks_c = cold.decode(ids, toks_c)
        toks = [hot.decode(ids, t) for hot, t in zip(hots, toks)]
        assert toks[1] == toks[0] == toks_c
    assert _segments_unchanged(hots[1].prefix_cache, snap)


@pytest.mark.parametrize("mode", ["copy", "share"])
def test_segments_stay_bit_unchanged(mode):
    """ROADMAP N2's hazard: sequences that share a segment prefill,
    decode, free and re-admit over it (slots reused, bindings dropped
    and re-made, the view cache invalidated), and every segment tensor
    keeps its bits."""
    _, te = _engines()
    dec = te.batched_decoder(max_seqs=3, prefix_block=4, prefix_bind=mode)
    dec.prefill_ex(PREFIX + [0, 1], 0)
    snap = _segment_snapshot(dec.prefix_cache)
    assert snap
    last = {0: dec.decode([0], [1])[0]}
    for round_ in range(2):
        for s, tail in ((1, [2]), (2, [3, 4])):
            last[s], cached = dec.prefill_ex(PREFIX + tail + [round_], s)
            assert cached == len(PREFIX)
        for _ in range(3):
            ids = sorted(last)
            last = dict(zip(ids, dec.decode(ids, [last[s] for s in ids])))
        assert _segments_unchanged(dec.prefix_cache, snap)
        dec.free(1)
        dec.free(2)
        del last[1], last[2]
    seg = next(s for s in dec.prefix_cache._segments if s.tokens[:9] ==
               tuple(PREFIX + [0]))
    assert seg.refcount == 0
    assert _segments_unchanged(dec.prefix_cache, snap)


def test_one_token_suffix_runs_on_k2():
    """A suffix of one token has the decode step's mask: its attention
    runs on K2 (lengths = boundary + 1), not K3, and its tokens are the
    JAX package's."""
    je, te = _engines()
    decs = [e.batched_decoder(max_seqs=2, prefix_block=4) for e in (je, te)]
    got = []
    for dec in decs:
        dec.prefill_ex(PREFIX + [1, 2], 0)
        k2, k3 = paged_attention.calls, flash_attention.calls
        tok, cached = dec.prefill_ex(PREFIX + [7], 1)
        if dec is decs[1]:
            assert (paged_attention.calls - k2,
                    flash_attention.calls - k3) == (SPEC_ARGS["n_layers"], 0)
        assert cached == len(PREFIX)
        got.append(_decode_n(dec, 1, tok, 4))
    assert got[1] == got[0]


def test_lookup_and_stats_match_jax():
    """The same token streams give the same lookup boundaries, segment
    tokens, stats and resident bytes in both packages (block 4, at most
    two segments, so that evictions happen).  The streams are 13 tokens
    long, sharing 0 to 12 tokens of one stem."""
    je, te = _engines()
    jpc, tpc = JPrefixCache(block=4, max_segments=2), \
        PrefixCache(block=4, max_segments=2)
    rng = np.random.default_rng(0)
    stem = [int(t) for t in rng.integers(0, 64, 12)]
    streams = [stem[:n] + [int(t) for t in rng.integers(0, 64, 13 - n)]
               for n in (12, 8, 12, 4, 12, 0, 8, 12)]
    for s in streams:
        hits = [pc.lookup(s) for pc in (jpc, tpc)]
        assert [(h[1], h[0].tokens) if h else None for h in hits[1:]] == \
            [(h[1], h[0].tokens) if h else None for h in hits[:1]]
        jpc.insert(s, je.start_session(s)["env"])
        tpc.insert(s, te.start_session(s)["env"])
        for f in ("hits", "misses", "insertions", "evictions",
                  "cached_tokens"):
            assert getattr(tpc.stats, f) == getattr(jpc.stats, f), f
        assert tpc.resident_bytes == jpc.resident_bytes
        assert [g.tokens for g in tpc._segments] == \
            [g.tokens for g in jpc._segments]
    assert tpc.stats.hits > 0 and tpc.stats.evictions > 0


# ---------------------------------------------------------------------------
# the reference's test_prefix_hit_decode_equals_cold (tests/test_property.py),
# f32 only
# ---------------------------------------------------------------------------


def test_prefix_hit_decode_equals_cold():
    """A batch whose every sequence admits via a prefix-cache hit
    generates exactly the tokens of a prefix-cache-disabled cold
    decoder, for any batch size, chunk size and bind mode."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(deadline=None, max_examples=8)
    @given(data=st.data())
    def prop(data):
        cs = data.draw(st.sampled_from([4, 8]), label="chunk_size")
        mode = data.draw(st.sampled_from(["copy", "share"]), label="bind")
        B = data.draw(st.integers(1, 3), label="batch")
        rng = np.random.default_rng(data.draw(st.integers(0, 99),
                                              label="seed"))
        _, eng = _engines(cs, max_len=16)
        prefix = [int(t) for t in rng.integers(0, 64, 8)]
        prompts = [prefix + [int(t) for t in rng.integers(0, 64, int(s))]
                   for s in rng.integers(1, 3, B)]
        cold = eng.batched_decoder(max_seqs=B, prefix_block=0)
        hot = eng.batched_decoder(max_seqs=B + 1, prefix_block=4,
                                  prefix_bind=mode)
        hot.prefill_ex(prefix + [0], B)
        hot.free(B)
        toks_c = [cold.prefill(p, i) for i, p in enumerate(prompts)]
        res = [hot.prefill_ex(p, i) for i, p in enumerate(prompts)]
        toks_h = [t for t, _ in res]
        assert all(c == len(prefix) for _, c in res)
        assert toks_h == toks_c
        ids = list(range(B))
        for _ in range(3):
            toks_c = cold.decode(ids, toks_c)
            toks_h = hot.decode(ids, toks_h)
            assert toks_h == toks_c

    prop()


# ---------------------------------------------------------------------------
# serving metrics: the prefix cache as a user sees it
# ---------------------------------------------------------------------------


def _serve_prefix_traffic(engine, paged, cfg, batcher, request, registry,
                          **kv):
    """Chatbot-shaped traffic: a donor of a 16-token shared prefix, then
    four requests of the same prefix plus unique tails of 1, 2, 4 and 6
    tokens, through ``ContinuousBatcher`` with ``prefill_ex``."""
    kvc = paged(cfg(n_layers=1, n_kv=2, head_dim=8, page_size=4,
                    n_pages=32, max_pages_per_seq=8), max_seqs=3, **kv)
    dec = engine.batched_decoder(max_seqs=3, prefix_block=4,
                                 prefix_bind="share")

    def prefill(req, seq_id):
        kvc.ensure_capacity(seq_id, len(req.context))
        return dec.prefill_ex(req.context, seq_id)

    sched = batcher(kvc, prefill, dec.decode, max_batch=3,
                    release_fn=dec.free, metrics=registry)
    rng = np.random.default_rng(5)
    shared = [int(t) for t in rng.integers(0, 64, 16)]
    sched.submit(request(rid=0, prompt=shared + [1, 2], max_new_tokens=3))
    sched.run()
    for rid, n in enumerate((1, 2, 4, 6), start=1):
        sched.submit(request(rid=rid, prompt=shared + [
            int(t) for t in rng.integers(0, 64, n)], max_new_tokens=3))
    done = sched.run()
    return {r.rid: r.generated for r in done}, sched, dec


def test_prefix_serving_metrics_match_jax():
    """The scrape that shows the prefix cache working: four hits at
    boundary 16, ``serving_prefills_total{kind="prefix_hit"}`` = 4, the
    hit/miss counters and segment gauges — every counter and gauge equal
    to the JAX package's for the same traffic, tokens identical."""
    te = RelationalEngine(LlamaSpec(**SPEC_ARGS), PARAMS, chunk_size=8,
                          max_len=32, device="cpu",
                          metrics=MetricsRegistry())
    jeng = JEngine(JSpec(**SPEC_ARGS), PARAMS, chunk_size=8, max_len=32,
                   row2col="off", cache_layout="off", metrics=JRegistry())
    want, jsched, jdec = _serve_prefix_traffic(
        jeng, JPaged, JPagedCfg, JBatcher, JRequest, jeng.metrics)
    got, tsched, tdec = _serve_prefix_traffic(
        te, PagedKVCache, PagedKVConfig, ContinuousBatcher, Request,
        te.metrics, device="cpu")
    assert got == want and len(got) == 5
    reg = te.metrics
    assert reg.counter("serving_prefills_total", kind="prefix_hit").value \
        == tsched.stats.prefills_prefix_hit == 4
    assert reg.counter("serving_prefix_cache_hits_total").value == 4
    assert tdec.prefix_cache.stats.cached_tokens == 4 * 16
    assert reg.gauge("serving_prefix_cache_resident_bytes").value == \
        tdec.prefix_cache.resident_bytes > 0
    assert reg.histogram("decoder_tick_seconds").count == tdec.decode_calls
    jd, td = jeng.metrics.to_dict(), reg.to_dict()
    assert sorted(td) == sorted(jd)

    def by_labels(series, field):
        return {json.dumps(s["labels"], sort_keys=True): s[field]
                for s in series}

    for name, series in jd.items():
        # latencies differ between the packages; counts and token-valued
        # histograms do not
        fields = (("value",) if series[0]["kind"] != "histogram" else
                  ("count",) if name.endswith("_seconds") else
                  ("count", "sum", "buckets"))
        for f in fields:
            assert by_labels(td[name], f) == by_labels(series, f), (name, f)


def test_engine_records_plan_cache_and_decode_step_metrics():
    reg = MetricsRegistry()
    te = RelationalEngine(LlamaSpec(**SPEC_ARGS), PARAMS, chunk_size=8,
                          max_len=16, device="cpu", metrics=reg)
    te.generate([3, 5], max_new_tokens=3)
    dump = reg.to_dict()
    assert dump["engine_decode_step_seconds"][0]["count"] == 2
    lookups = {tuple(sorted(e["labels"].items())): e["value"]
               for e in dump["engine_plan_cache_total"]}
    assert lookups[(("cache", "prefill"), ("outcome", "miss"))] == 1.0


# ---------------------------------------------------------------------------
# the reference's metrics tests (tests/test_obs.py), on both registries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Registry", REGISTRIES)
class TestMetricsRegistry:
    def test_counter_gauge_histogram(self, Registry):
        r = Registry()
        r.counter("reqs_total").inc()
        r.counter("reqs_total").inc(2)
        assert r.counter("reqs_total").value == 3
        with pytest.raises(ValueError):
            r.counter("reqs_total").inc(-1)
        r.gauge("occupancy").set(0.5)
        r.gauge("occupancy").inc(0.25)
        assert r.gauge("occupancy").value == 0.75
        h = r.histogram("lat_seconds")
        for v in (0.001, 0.002, 0.004, 0.1):
            h.observe(v)
        assert h.count == 4 and h.sum == pytest.approx(0.107)
        assert 0.001 <= h.percentile(50) <= 0.004
        assert h.mean == pytest.approx(0.107 / 4)

    def test_labels_create_separate_series(self, Registry):
        r = Registry()
        r.counter("cache_total", outcome="hit").inc(3)
        r.counter("cache_total", outcome="miss").inc()
        assert r.counter("cache_total", outcome="hit").value == 3
        assert r.counter("cache_total", outcome="miss").value == 1

    def test_kind_conflict_rejected(self, Registry):
        r = Registry()
        r.counter("x_total")
        with pytest.raises(ValueError):
            r.gauge("x_total")

    def test_prometheus_exposition(self, Registry):
        r = Registry()
        r.counter("hits_total", "cache hits", cache="plan").inc(5)
        r.histogram("tick_seconds", "tick latency").observe(0.003)
        text = r.render_prometheus()
        assert '# TYPE hits_total counter' in text
        assert 'hits_total{cache="plan"} 5' in text
        assert '# TYPE tick_seconds histogram' in text
        # cumulative buckets: every bound >= 0.003 counts the observation
        assert 'tick_seconds_bucket{le="0.005"} 1' in text
        assert 'tick_seconds_bucket{le="0.001"} 0' in text
        assert 'tick_seconds_bucket{le="+Inf"} 1' in text
        assert 'tick_seconds_count 1' in text

    def test_histogram_exemplars_track_buckets(self, Registry):
        r = Registry()
        h = r.histogram("ttft_seconds", buckets=(0.01, 0.1, 1.0))
        h.observe(0.005, exemplar="aaa0")
        h.observe(0.05, exemplar="bbb1")
        h.observe(0.06, exemplar="ccc2")   # same bucket: last wins
        h.observe(5.0, exemplar="ddd3")    # above every bound: +Inf
        h.observe(0.5)                     # no exemplar: leaves none
        assert h.exemplars[0][0] == "aaa0"
        assert h.exemplars[1][0] == "ccc2"
        assert h.exemplars[len(h.bounds)][0] == "ddd3"
        assert 2 not in h.exemplars

    def test_openmetrics_render_carries_exemplars_and_eof(self, Registry):
        r = Registry()
        r.counter("reqs_total", "requests").inc(2)
        h = r.histogram("ttft_seconds", buckets=(0.01, 1.0))
        h.observe(0.005, exemplar="cafe1234")
        om = r.render_openmetrics()
        assert om.endswith("# EOF\n")
        line = next(ln for ln in om.splitlines()
                    if ln.startswith('ttft_seconds_bucket{le="0.01"}'))
        assert '# {trace_id="cafe1234"} 0.005' in line
        # buckets without an exemplar render bare
        bare = next(ln for ln in om.splitlines()
                    if ln.startswith('ttft_seconds_bucket{le="1.0"}'))
        assert "#" not in bare
        # the classic exposition stays exemplar- and EOF-free
        prom = r.render_prometheus()
        assert "cafe1234" not in prom and "# EOF" not in prom

        # ... and the series names line up between the two renders
        def names(text):
            return {ln.split("{")[0].split()[0] for ln in text.splitlines()
                    if ln and not ln.startswith("#")}
        assert names(prom) == names(om)

    def test_exemplars_survive_merge(self, Registry):
        parent = Registry()
        child = Registry()
        child.histogram("lat_seconds").observe(0.003, exemplar="feed1")
        parent.merge(child, shard=0)
        merged = parent.histogram("lat_seconds", shard="0")
        assert any(tid == "feed1"
                   for tid, _, _ in merged.exemplars.values())

    def test_json_dump_roundtrips(self, Registry, tmp_path):
        r = Registry()
        r.histogram("h_seconds").observe(0.01)
        r.histogram("empty_seconds")  # no observations: no percentiles
        path = str(tmp_path / "metrics.json")
        r.save_json(path)
        with open(path) as f:
            dump = json.load(f)
        assert dump["h_seconds"][0]["p50"] == pytest.approx(0.01)
        assert "p50" not in dump["empty_seconds"][0]


@pytest.mark.parametrize("Registry", REGISTRIES)
class TestMetricsConcurrency:
    """Series mutated from several threads keep exact totals."""

    def test_concurrent_writers_keep_exact_totals(self, Registry):
        r = Registry()
        threads_n, iters = 8, 400
        barrier = threading.Barrier(threads_n)

        def hammer():
            barrier.wait()  # maximise interleaving
            for _ in range(iters):
                r.counter("stress_total").inc()
                r.counter("stress_total", shard="x").inc(2)
                r.gauge("stress_gauge").inc(0.5)
                r.histogram("stress_seconds").observe(0.001)

        ts = [threading.Thread(target=hammer) for _ in range(threads_n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        total = threads_n * iters
        assert r.counter("stress_total").value == total
        assert r.counter("stress_total", shard="x").value == 2 * total
        assert r.gauge("stress_gauge").value == pytest.approx(0.5 * total)
        h = r.histogram("stress_seconds")
        assert h.count == total
        assert h.sum == pytest.approx(0.001 * total)
        # cumulative buckets stayed consistent under contention
        assert h.bucket_counts[h.bounds.index(0.001)] == total

    def test_merge_relabels_and_adds(self, Registry):
        parent = Registry()
        parent.counter("ticks_total").inc(5)
        for i in range(2):
            child = Registry()
            child.counter("ticks_total").inc(10 * (i + 1))
            child.gauge("busy_frac").set(0.25 * (i + 1))
            child.histogram("lat_seconds").observe(0.002 * (i + 1))
            parent.merge(child, shard=i)
        # the parent's own unlabelled series is untouched …
        assert parent.counter("ticks_total").value == 5
        # … and each child landed under its shard label
        assert parent.counter("ticks_total", shard="0").value == 10
        assert parent.counter("ticks_total", shard="1").value == 20
        assert parent.gauge("busy_frac", shard="1").value == 0.5
        h0 = parent.histogram("lat_seconds", shard="0")
        assert h0.count == 1 and h0.percentile(50) == \
            pytest.approx(0.002)
        # merging is additive: a second merge doubles the counter
        child = Registry()
        child.counter("ticks_total").inc(10)
        parent.merge(child, shard="0")
        assert parent.counter("ticks_total", shard="0").value == 20

    def test_merge_rejects_mismatched_histogram_bounds(self, Registry):
        parent = Registry()
        parent.histogram("lat_seconds", buckets=(0.1, 1.0)).observe(0.05)
        child = Registry()
        child.histogram("lat_seconds", buckets=(0.2, 2.0)).observe(0.05)
        with pytest.raises(ValueError):
            parent.merge(child)


@pytest.mark.parametrize("Registry", REGISTRIES)
def test_scheduler_metrics(Registry):
    """The port's scheduler against either registry (the reference's
    ``TestServingMetricsSmoke::test_scheduler_metrics``)."""
    cfg = PagedKVConfig(n_layers=1, n_kv=1, head_dim=4, page_size=4,
                        n_pages=16, max_pages_per_seq=4)
    kv = PagedKVCache(cfg, max_seqs=4, device="cpu")
    reg = Registry()

    def prefill(req, seq_id):
        kv.ensure_capacity(seq_id, len(req.prompt))
        return 1

    sched = ContinuousBatcher(kv, prefill,
                              lambda ids, toks: [2] * len(ids),
                              max_batch=2, metrics=reg)
    for r in range(3):
        sched.submit(Request(rid=r, prompt=[1, 2], max_new_tokens=2))
    done = sched.run()
    assert len(done) == 3
    dump = reg.to_dict()
    assert dump["serving_ttft_seconds"][0]["count"] == 3
    assert dump["serving_completed_total"][0]["value"] == 3.0
    assert dump["serving_tick_seconds"][0]["count"] == \
        sched.stats.decode_steps
    assert 0 < reg.gauge("serving_batch_occupancy").value <= 1.0
