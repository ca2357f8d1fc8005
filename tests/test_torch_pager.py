"""The port's paged residency (``WeightPager``, ``LazyEnv``, the engine's
Disk+mem mode) against the JAX package's.

Both pagers take the same sequences of ``add``, ``get`` and joined
``prefetch`` calls and must end with equal ``PagerStats``, equal hot sets
and equal held bytes (the reference's pager tests, ported, each also held
to the reference).  Both engines run paged over the same numpy weights
(the port on the CPU, with the kernels' plain versions): tokens are
identical, logits within 1e-5, and plan decisions under a budget equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.obs as jobs  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro.core.llama_graph import LlamaSpec as JSpec  # noqa: E402
from repro.core.llama_graph import init_llama_params  # noqa: E402
from repro.obs.metrics import MetricsRegistry as JRegistry  # noqa: E402
from repro.serving.engine import RelationalEngine as JEngine  # noqa: E402
from repro.serving.pager import WeightPager as JPager  # noqa: E402
from repro_torch.core.llama_graph import LlamaSpec  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.serving.engine import LazyEnv, RelationalEngine  # noqa: E402
from repro_torch.serving.engine import _chunked_table  # noqa: E402
from repro_torch.serving.pager import WeightPager  # noqa: E402

SPEC_ARGS = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv=2,
                 d_ff=64, rope_theta=10000.0)
J_SPEC, T_SPEC = JSpec(**SPEC_ARGS), LlamaSpec(**SPEC_ARGS)
PARAMS = init_llama_params(J_SPEC, seed=0)
PROMPT = [3, 17, 42, 5, 9]


def _pagers(budget, **kw):
    """The reference's pager and the port's (hot set on the CPU)."""
    return JPager(budget, **kw), WeightPager(budget, device="cpu", **kw)


def _state(pager):
    return (vars(pager.stats), sorted(pager._hot), sorted(pager._prefetched),
            pager.held_bytes, list(pager._clock), pager._hand)


def _both(pagers, fn):
    for p in pagers:
        fn(p)
    assert _state(pagers[0]) == _state(pagers[1])


# -- the reference's TestPager (tests/test_serving.py), on both pagers -------


def test_clock_eviction_and_reuse():
    pagers = _pagers(3 * 400)  # 3 × 100 f32

    def run(pager):
        for i in range(6):
            pager.add(f"w{i}", np.full(100, i, np.float32))
        for i in range(6):
            pager.get(f"w{i}")

    _both(pagers, run)
    pager = pagers[1]
    assert pager.stats.evictions >= 3
    assert pager.held_bytes <= 3 * 400
    # re-access: values still correct after paging back in
    np.testing.assert_array_equal(pager.get("w0").numpy(),
                                  np.full(100, 0, np.float32))


def test_prefetch_counts_as_hit():
    def run(pager):
        pager.add("a", np.zeros(64, np.float32))
        pager.prefetch(["a"]).join(timeout=30)
        pager.get("a")

    pagers = _pagers(1 << 20)
    _both(pagers, run)
    assert pagers[1].stats.prefetch_hits == 1
    assert pagers[1].stats.misses == 0


def test_disk_tier_memmap(tmp_path):
    x = np.arange(32, dtype=np.float32)
    pagers = (JPager(1 << 20, disk_dir=str(tmp_path / "jax")),
              WeightPager(1 << 20, disk_dir=str(tmp_path / "port"),
                          device="cpu"))
    _both(pagers, lambda p: p.add("w", x))
    assert isinstance(pagers[1]._cold["w"], np.memmap)
    # both packages write the same bytes
    assert (tmp_path / "port" / "w.npy").read_bytes() == \
        (tmp_path / "jax" / "w.npy").read_bytes()
    np.testing.assert_array_equal(pagers[1].get("w").numpy(), x)


def test_prefetch_accounts_against_budget():
    """Prefetched tensors live on the device, so they count toward the
    budget: the entry that does not fit is dropped, and pages in later
    through the ordinary miss path."""
    pagers = _pagers(2 * 400)  # room for 2 × 100 f32

    def run(pager):
        for i in range(3):
            pager.add(f"w{i}", np.full(100, i, np.float32))
        pager.prefetch(["w0", "w1", "w2"]).join(timeout=30)

    _both(pagers, run)
    pager = pagers[1]
    assert pager.held_bytes <= 2 * 400
    assert len(pager._prefetched) == 2
    _both(pagers, lambda p: p.get("w0"))
    assert pager.held_bytes <= 2 * 400
    assert pager.stats.prefetch_hits == 1
    _both(pagers, lambda p: p.get("w2"))
    np.testing.assert_array_equal(pager.get("w2").numpy(),
                                  np.full(100, 2, np.float32))
    assert pager.stats.misses == 1
    assert pager.held_bytes <= 2 * 400


def test_prefetch_evicts_hot_entries_to_fit():
    def run(pager):
        for k in ("a", "b", "c"):
            pager.add(k, np.full(100, ord(k), np.float32))
        pager.get("a")
        pager.get("b")
        assert pager.held_bytes == 2 * 400
        pager.prefetch(["c"]).join(timeout=30)

    pagers = _pagers(2 * 400)
    _both(pagers, run)
    assert "c" in pagers[1]._prefetched
    assert pagers[1].held_bytes <= 2 * 400
    assert pagers[1].stats.evictions >= 1


def test_clock_hand_keeps_scan_position_after_eviction():
    """The corrected CLOCK hand: the unreferenced entries go first and the
    referenced "a" survives the three evictions."""
    def run(pager):
        for k in "abcdefg":
            pager.add(k, np.full(100, ord(k), np.float32))
        for k in "abcd":
            pager.get(k)
        pager._ref.update({"a": True, "b": False, "c": True, "d": False})
        pager._hand = 5
        for k in "efg":
            pager.get(k)

    pagers = _pagers(4 * 400, policy="clock")
    _both(pagers, run)
    assert "a" in pagers[1]._hot
    assert not {"b", "c", "d"} & set(pagers[1]._hot)


# -- the property test and the metrics mirror --------------------------------


def test_pager_budget_invariant():
    """The hot set never exceeds the budget when every tensor fits it, and
    the port's stats equal the reference's."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(deadline=None, max_examples=25)
    @given(budget_items=st.integers(1, 5), n_weights=st.integers(2, 10),
           seed=st.integers(0, 99))
    def check(budget_items, n_weights, seed):
        item = 1024 * 4  # 1024 f32
        pagers = _pagers(budget_items * item)
        for p in pagers:
            for i in range(n_weights):
                p.add(f"w{i}", np.zeros(1024, np.float32))
        rng = np.random.default_rng(seed)
        for _ in range(50):
            name = f"w{rng.integers(n_weights)}"
            for p in pagers:
                p.get(name)
                assert p.held_bytes <= budget_items * item
        s = pagers[1].stats
        assert s.hits + s.misses == 50
        assert _state(pagers[0]) == _state(pagers[1])

    check()


def test_pager_metrics_mirror_stats():
    regs = JRegistry(), MetricsRegistry()
    pagers = (JPager(64, policy="clock", metrics=regs[0]),
              WeightPager(64, policy="clock", metrics=regs[1], device="cpu"))

    def run(pager):
        for k in "abc":
            pager.add(k, np.zeros(8, np.float32))   # 32 B
        pager.get("a"); pager.get("b"); pager.get("a")  # hit
        pager.get("c")                                  # evicts

    _both(pagers, run)
    reg, pager = regs[1], pagers[1]
    assert reg.counter("pager_hits_total").value == pager.stats.hits
    assert reg.counter("pager_misses_total").value == pager.stats.misses
    assert reg.counter("pager_evictions_total").value == \
        pager.stats.evictions > 0
    assert reg.gauge("pager_held_bytes").value == pager.held_bytes
    assert reg.to_dict() == regs[0].to_dict()


# -- the differential sequence -----------------------------------------------


@pytest.mark.parametrize("policy", ["clock", "pin"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_sequence_matches_reference(policy, seed):
    """A seeded sequence of adds, gets and joined prefetches of tensors of
    mixed sizes and dtypes (one larger than the budget) through both
    pagers: equal stats, hot sets, clock state and held bytes after every
    call, and every fetched tensor equal to what was added."""
    rng = np.random.default_rng(seed)
    pagers = _pagers(6000, policy=policy)
    added = {}
    for _ in range(120):
        op = rng.choice(["add", "get", "get", "get", "prefetch"])
        if op == "add" or not added:
            name = f"t{len(added)}"
            n = int(rng.choice([16, 100, 250, 400, 1600]))
            dtype = rng.choice([np.float32, np.int8])
            arr = rng.integers(-100, 100, n).astype(dtype)
            added[name] = arr
            _both(pagers, lambda p: p.add(name, arr))
        elif op == "get":
            name = f"t{rng.integers(len(added))}"
            _both(pagers, lambda p: p.get(name))
            np.testing.assert_array_equal(pagers[1]._hot[name].numpy(),
                                          added[name])
        else:
            names = [f"t{i}" for i in rng.integers(len(added), size=3)]
            _both(pagers, lambda p: p.prefetch(names).join(timeout=30))
    assert pagers[1].stats.evictions > 0
    assert pagers[1].total_cold_bytes() == pagers[0].total_cold_bytes()


def test_pad_to_pads_the_cold_entry():
    pagers = _pagers(1 << 20)
    x = np.arange(10, dtype=np.float32).reshape(2, 5)
    _both(pagers, lambda p: p.add("w", x, pad_to=4))
    np.testing.assert_array_equal(pagers[1].get("w").numpy(),
                                  np.asarray(pagers[0].get("w")))
    assert tuple(pagers[1].get("w").shape) == (2, 8)


def span_key(e):
    """A span's name, category, depth and args (values as text)."""
    return (e.name, e.cat, e.depth,
            tuple(sorted((k, str(v)) for k, v in e.args.items())))


def test_tracer_raises_naming_n6():
    """Named for what it pinned before the tracer was ported
    (``WeightPager(tracer=)`` raised naming N6).  Now: one
    ``pager_fetch:`` span a miss and one ``pager_prefetch:`` span a
    prefetched entry, at depth 1 with the cold entry's bytes, the request
    ids of the ambient context on the fetches and none on the prefetch
    thread's, equal to the reference pager's on one add/get/prefetch
    sequence."""
    rng = np.random.default_rng(0)
    tables = {f"w{i}": rng.standard_normal((4, 8 * (i + 1))).astype(
        np.float32) for i in range(5)}
    spans = []
    for obs, pager_cls, kw in ((jobs, JPager, {}),
                               (tobs, WeightPager, {"device": "cpu"})):
        tracer = obs.TraceRecorder()
        pager = pager_cls(2000, policy="pin", tracer=tracer, **kw)
        for name, arr in tables.items():
            pager.add(name, arr)
        with obs.activate(obs.TraceContext.for_request(3, "cd" * 8)):
            for name in ("w0", "w1", "w0", "w4", "w2"):
                pager.get(name)
        pager.prefetch(["w3", "w1"]).join(timeout=30)
        pager.get("w3")
        spans.append([span_key(e) for e in tracer.events])
    assert spans[0] == spans[1]
    fetched = [k[0] for k in spans[1]]
    assert fetched[:4] == ["pager_fetch:w0", "pager_fetch:w1",
                           "pager_fetch:w4", "pager_fetch:w2"]
    assert fetched[4].startswith("pager_prefetch:")
    assert all(k[1] == "pager" and k[2] == 1 for k in spans[1])
    assert ("rids", "[3]") in spans[1][0][3]
    assert all(a[0] != "rids" for a in spans[1][-1][3])


def test_cuda_pager_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        WeightPager(1 << 20)


# -- LazyEnv ---------------------------------------------------------------


@pytest.mark.parametrize("disk", [False, True])
def test_lazy_env_wraps_without_a_copy(tmp_path, disk):
    """The wrapped chunk column is a view of the pager's hot tensor, also
    for a planner chunk size that needed the cold store's padding."""
    pager = WeightPager(1 << 20, device="cpu",
                        disk_dir=str(tmp_path) if disk else None)
    w = np.random.default_rng(0).standard_normal((6, 40)).astype(np.float32)
    pager.add("w", w)
    pager.add("w_padded", w, pad_to=16)
    env = LazyEnv(pager, 8, _chunked_table, table_sizes={"w_padded": 16})
    assert "w" in env and "w_padded" in env and "other" not in env
    for name, cs, width in (("w", 8, 40), ("w_padded", 16, 48)):
        tbl = env[name]
        col = tbl.cols["chunk"]
        hot = pager._hot[name]
        assert col.untyped_storage().data_ptr() == \
            hot.untyped_storage().data_ptr()
        assert tuple(col.shape) == (6, width // cs, cs)
        np.testing.assert_array_equal(col.reshape(6, -1)[:, :40].numpy(), w)
    assert not dict.__contains__(env, "w")  # not retained
    assert isinstance(env.copy(), LazyEnv)


# -- the engine's Disk+mem mode ----------------------------------------------


def _engine_pair(tmp_path=None, **kw):
    jkw, tkw = dict(kw), dict(kw, device="cpu")
    if tmp_path is not None:
        jkw["disk_dir"] = str(tmp_path / "jax")
        tkw["disk_dir"] = str(tmp_path / "port")
    base = dict(chunk_size=8, max_len=16)
    return (JEngine(J_SPEC, PARAMS, **dict(base, **jkw)),
            RelationalEngine(T_SPEC, PARAMS, **dict(base, **tkw)))


def _decisions(eng):
    plan = eng.decode_pipe.layout_plan
    return ([(d.table, d.layout, d.chunk_size, d.denied_by_budget)
             for d in plan.decisions],
            [(d.table, d.precision) for d in plan.precision_decisions],
            [(d.table, d.layout) for d in plan.cache_decisions])


def _scans(stats):
    return stats["hits"] + stats["prefetch_hits"] + stats["misses"]


def test_relational_paged_matches_direct(tmp_path):
    """The reference's Disk+mem system test (memmap cold store, a bounded
    working set) through both engines: identical tokens, logits within
    1e-5, and the port really paged with the budget enforced."""
    weights = init_llama_params(J_SPEC, seed=3)
    kw = dict(chunk_size=8, residency="paged", budget_bytes=64 * 1024,
              max_len=32)
    je = JEngine(J_SPEC, weights, disk_dir=str(tmp_path / "jax"), **kw)
    te = RelationalEngine(T_SPEC, weights, disk_dir=str(tmp_path / "port"),
                          device="cpu", **kw)
    prompt = [5, 9, 2, 7]
    jr, tr = je.generate(prompt, max_new_tokens=6), te.generate(
        prompt, max_new_tokens=6)
    assert tr.tokens == jr.tokens
    np.testing.assert_allclose(te.start_session(prompt)["logits"],
                               je.start_session(prompt)["logits"],
                               rtol=1e-5, atol=1e-5)
    assert tr.pager_stats["misses"] > 0          # it really paged
    assert tr.pager_stats["evictions"] > 0       # budget enforced
    assert tr.peak_working_set <= 64 * 1024
    # the vocabulary prefetch races the first Scan in both packages, so a
    # hit may land on either side of it; the Scans and bytes do not move
    assert _scans(tr.pager_stats) == _scans(jr.pager_stats)
    assert tr.pager_stats["bytes_loaded"] == jr.pager_stats["bytes_loaded"]


# the paged cases of tests/test_planner.py: (knobs, budget)
PLANNED_PAGED = {
    "row2col=auto": dict(row2col="auto"),
    "chunk_size=auto": dict(chunk_size="auto",
                            chunk_candidates=(4, 8, 16, 32)),
    "pager_policy=clock": dict(pager_policy="clock"),
    "budget below the working set": dict(budget_bytes=24_000),
}


@pytest.mark.parametrize("disk", [True, False], ids=["disk", "pinned"])
@pytest.mark.parametrize("knobs", PLANNED_PAGED.values(),
                         ids=list(PLANNED_PAGED))
def test_paged_plans_and_tokens_match_jax(tmp_path, knobs, disk):
    """Paged engines under a budget in both packages: equal plan decisions
    (layouts, chunk sizes, budget denials, precisions, caches), equal
    column tables committed to the shared pool, identical tokens equal to
    the unplanned in-memory engine's, prefill logits within 1e-5."""
    kw = dict(dict(residency="paged", budget_bytes=1 << 20), **knobs)
    je, te = _engine_pair(tmp_path if disk else None, **kw)
    assert _decisions(te) == _decisions(je)
    assert te.cs == je.cs and te._table_chunks == je._table_chunks
    ref = JEngine(J_SPEC, PARAMS, chunk_size=8, max_len=16, row2col="off")
    np.testing.assert_allclose(te.start_session(PROMPT)["logits"],
                               je.start_session(PROMPT)["logits"],
                               rtol=1e-5, atol=1e-5)
    got, want = te.generate(PROMPT, 4), je.generate(PROMPT, 4)
    assert got.tokens == want.tokens == ref.generate(PROMPT, 4).tokens
    assert got.pager_stats is not None
    assert _scans(got.pager_stats) == _scans(want.pager_stats)
    assert got.peak_working_set <= kw["budget_bytes"]
    tp, jp = te._residency_pool, je._residency_pool
    assert (tp.budget_bytes, tp.spent, tp.tables) == \
        (jp.budget_bytes, jp.spent, jp.tables)
    assert tp.spent <= kw["budget_bytes"]


def test_chunk_auto_paged_planned_sizes_differ_from_base(tmp_path):
    """Paged sessions wrap cold weights at the planner's per-table chunk
    sizes, not the base size (the reference's regression), in both
    packages alike."""
    args = dict(SPEC_ARGS, d_ff=48)
    p48 = init_llama_params(JSpec(**args), seed=0)
    kw = dict(chunk_size="auto", max_len=16, chunk_candidates=(16, 48),
              residency="paged", budget_bytes=1 << 20)
    je = JEngine(JSpec(**args), p48, disk_dir=str(tmp_path / "j"), **kw)
    te = RelationalEngine(LlamaSpec(**args), p48,
                          disk_dir=str(tmp_path / "t"), device="cpu", **kw)
    assert te._table_chunks == je._table_chunks
    assert {t: cs for t, cs in te._table_chunks.items() if cs != te.cs}
    assert te.generate([3, 17, 42], 4).tokens == \
        je.generate([3, 17, 42], 4).tokens


def test_engine_shares_one_pool(tmp_path):
    """The decode and prefill plans commit no more than the budget in
    total, and prefill reuses decode's column copies (as in JAX)."""
    budget = 1 << 20
    je, te = _engine_pair(tmp_path, residency="paged", budget_bytes=budget)
    for e in (je, te):
        e.generate(PROMPT[:5], 3)
    pool = te._residency_pool
    assert pool.budget_bytes == budget and pool.spent <= budget
    assert pool.spent == sum(pool.tables.values())
    prefill_pipe = next(iter(te._prefill_pipes.values()))
    for d in prefill_pipe.layout_plan.col_decisions:
        assert d.col_table in pool.tables
    assert pool.tables == je._residency_pool.tables


def test_quantised_paged_matches_in_memory(tmp_path):
    """int8 payloads paged as packed codes: the same tokens as the
    in-memory quantised engine and the JAX paged one, a working set under
    half of f32's, and the cold codes equal to the reference's."""
    je, te = _engine_pair(tmp_path, precision="int8", residency="paged",
                          budget_bytes=1 << 20)
    inm = RelationalEngine(T_SPEC, PARAMS, chunk_size=8, max_len=16,
                           precision="int8", device="cpu")
    gp, gi = te.generate(PROMPT, 4), inm.generate(PROMPT, 4)
    assert gp.tokens == gi.tokens == je.generate(PROMPT, 4).tokens
    for name in je.pager._cold:
        if name.endswith(("::q", "::scale")):
            np.testing.assert_array_equal(
                te.pager.cold_tensor(name).numpy(),
                np.asarray(je.pager._cold[name]))
    f32 = RelationalEngine(T_SPEC, PARAMS, chunk_size=8, max_len=16,
                           residency="paged", budget_bytes=1 << 20,
                           device="cpu")
    assert gp.peak_working_set * 2 < f32.generate(PROMPT, 4).peak_working_set


@pytest.mark.parametrize("precision", ["int8", "nf4"])
def test_paged_quant_codes_equal_reference(precision):
    je, te = _engine_pair(precision=precision, residency="paged",
                          budget_bytes=1 << 20)
    assert te._quant_specs.keys() == je._quant_specs.keys()
    for name in je.pager._cold:
        np.testing.assert_array_equal(te.pager.cold_tensor(name).numpy(),
                                      np.asarray(je.pager._cold[name]))
    assert te.generate(PROMPT, 4).tokens == je.generate(PROMPT, 4).tokens


def test_auto_admits_quantised_under_budget(tmp_path):
    """precision="auto" quantises at least one table under a constrained
    budget, choosing what JAX chooses, and the engine still generates."""
    je, te = _engine_pair(tmp_path, precision="auto", residency="paged",
                          budget_bytes=40_000)
    assert len(te.table_precision_choices) >= 1
    assert te.table_precision_choices == je.table_precision_choices
    assert te.generate([3, 17, 42], 3).tokens == \
        je.generate([3, 17, 42], 3).tokens


def test_budget_turns_on_sharing_and_bounds_the_prefix_cache():
    """With a budget, BatchedDecoder's prefix cache is bounded by it and
    ``prefix_bind="auto"`` shares, as in the reference; the paged batched
    decoder gives the JAX paged decoder's tokens."""
    je, te = _engine_pair(residency="paged", budget_bytes=1 << 20,
                          max_len=32)
    jd, td = je.batched_decoder(3), te.batched_decoder(3)
    assert td.prefix_cache.budget_bytes == 1 << 20
    assert td._resolve_bind(16) == jd._resolve_bind(16) == "share"
    shared = list(range(1, 17))
    last = {}
    for s, tail in enumerate(([20], [21, 22], [23])):
        want = jd.prefill_ex(shared + tail, s)
        assert td.prefill_ex(shared + tail, s) == want
        last[s] = want[0]
    for _ in range(3):
        ids = sorted(last)
        toks = jd.decode(ids, [last[s] for s in ids])
        assert td.decode(ids, [last[s] for s in ids]) == toks
        last = dict(zip(ids, toks))
    assert td.prefix_cache.stats.hits == jd.prefix_cache.stats.hits > 0
