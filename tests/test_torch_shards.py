"""The port's shard worker pool (``serving/shards.py``) and the engine's
``shards`` knob against the JAX package's.

The pool's slice and combine units are held to the reference's on the same
tables; sharded engines (in memory and paged, f32 and int8) give the
tokens of the unsharded engine and of the JAX package's sharded engine,
run the same number of per-shard plan copies, and fold their workers'
metrics into the engine registry under a ``shard`` label.  On the CPU the
workers have no streams; ``tests/test_torch_gpu.py`` runs them on the
card.
"""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.obs as jobs  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro.core import relational as jra  # noqa: E402
from repro.core.executor import DenseTable as JTable  # noqa: E402
from repro.core.llama_graph import LlamaSpec as JSpec  # noqa: E402
from repro.core.llama_graph import init_llama_params  # noqa: E402
from repro.planner.shard import ShardDecision as JDecision  # noqa: E402
from repro.serving.engine import RelationalEngine as JEngine  # noqa: E402
from repro.serving.shards import ShardWorkerPool as JPool  # noqa: E402
from repro.serving.shards import slice_table as jslice  # noqa: E402
from repro_torch.core import relational as ra  # noqa: E402
from repro_torch.core.executor import DenseTable  # noqa: E402
from repro_torch.core.llama_graph import LlamaSpec  # noqa: E402
from repro_torch.kernels import chunked_matmul  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.planner.shard import (COMBINE_CONCAT,  # noqa: E402
                                       COMBINE_SUM, ShardDecision)
from repro_torch.serving.engine import RelationalEngine  # noqa: E402
from repro_torch.serving.shards import (ShardWorkerPool,  # noqa: E402
                                        slice_table)

# the reference's test spec: wide enough that every matmul site passes the
# benefit > combine-cost pricing gate
SPEC_ARGS = dict(vocab=64, d_model=32, n_layers=1, n_heads=4, n_kv=2,
                 d_ff=64, rope_theta=10000.0)
J_SPEC, T_SPEC = JSpec(**SPEC_ARGS), LlamaSpec(**SPEC_ARGS)
PARAMS = init_llama_params(J_SPEC, seed=0)
CS = 4


# -- TestWorkerPoolUnits ---------------------------------------------------


def test_slice_table_broadcasts_lazy_columns():
    full = np.arange(24, dtype=np.float32).reshape(6, 4)
    lazy = np.full((1,), 2.5, np.float32)  # broadcast over key "c"
    t = DenseTable(keys=(("c", 6),),
                   cols={"v": torch.from_numpy(full),
                         "s": torch.from_numpy(lazy)},
                   col_types={"v": ra.VEC(4), "s": ra.SCALAR})
    j = JTable(keys=(("c", 6),), cols={"v": full, "s": lazy},
               col_types={"v": jra.VEC(4), "s": jra.SCALAR})
    s, js = slice_table(t, "c", 2, 5), jslice(j, "c", 2, 5)
    assert s.keys == js.keys == (("c", 3),)
    for c in ("v", "s"):
        np.testing.assert_array_equal(s.cols[c].numpy(),
                                      np.asarray(js.cols[c]))
    # a view of the table, not a copy
    assert s.cols["v"].data_ptr() == t.cols["v"].data_ptr() + 2 * 4 * 4
    np.testing.assert_array_equal(s.cols["s"].numpy(),
                                  np.full(3, 2.5, np.float32))


def _partials(combine, mod):
    kw = dict(step_name="s", table="W", axis="c", axis_size=4, kind="row",
              combine=combine, logical_axis="inner", ranges=((0, 2), (2, 4)))
    a = np.arange(8, dtype=np.float32).reshape(4, 2)
    b = 10 * np.ones((4, 2), np.float32)
    if mod == "jax":
        mk = lambda x: JTable(keys=(("c", 4),), cols={"v": x},  # noqa: E731
                              col_types={"v": jra.VEC(2)})
        return JDecision(**kw), [mk(a), mk(b)]
    mk = lambda x: DenseTable(keys=(("c", 4),),  # noqa: E731
                              cols={"v": torch.from_numpy(x)},
                              col_types={"v": ra.VEC(2)})
    return ShardDecision(**kw), [mk(a), mk(b)]


@pytest.mark.parametrize("combine,keys,want", [
    (COMBINE_SUM, (("c", 4),), lambda a, b: a + b),
    (COMBINE_CONCAT, (("c", 8),), lambda a, b: np.concatenate([a, b]))],
    ids=["sum", "concat"])
def test_combine_matches_reference(combine, keys, want):
    dec, parts = _partials(combine, "torch")
    jdec, jparts = _partials(combine, "jax")
    out = ShardWorkerPool._combine(dec, parts)
    jout = JPool._combine(jdec, jparts)
    assert out.keys == jout.keys == keys
    got = out.cols["v"].numpy()
    np.testing.assert_array_equal(got, np.asarray(jout.cols["v"]))
    np.testing.assert_array_equal(
        got, want(parts[0].cols["v"].numpy(), parts[1].cols["v"].numpy()))


def test_combine_sum_adds_in_shard_order():
    """Three partials whose sum depends on the order of the additions in
    f32: the combine adds them in shard order, whatever order they came
    back in."""
    dec, _ = _partials(COMBINE_SUM, "torch")
    vals = [np.float32(1e8), np.float32(1.0), np.float32(-1e8)]
    parts = [DenseTable(keys=(("c", 1),),
                        cols={"v": torch.full((1, 1), float(v))},
                        col_types={"v": ra.VEC(1)}) for v in vals]
    got = ShardWorkerPool._combine(dec, parts).cols["v"].item()
    assert got == float((vals[0] + vals[1]) + vals[2])


def test_pool_rejects_single_worker():
    with pytest.raises(ValueError):
        ShardWorkerPool(1, device="cpu")
    with pytest.raises(ValueError):
        JPool(1)


# -- TestShardedEngine -------------------------------------------------------


def _tokens(eng, prompt=(3, 17, 42), steps=3):
    sess = eng.start_session(list(prompt))
    toks = [sess["tok"]]
    for _ in range(steps):
        toks.append(eng.session_step(sess))
    return toks


def _engines(**kw):
    base = dict(chunk_size=CS, max_len=8)
    return (JEngine(J_SPEC, PARAMS, **dict(base, **kw)),
            RelationalEngine(T_SPEC, PARAMS, device="cpu",
                             **dict(base, **kw)))


SHARDED = {
    "in_memory": dict(),
    "paged clock": dict(residency="paged", budget_bytes=1 << 22,
                        pager_policy="clock"),
    "paged pin, tight budget": dict(residency="paged", budget_bytes=12_000),
    "paged int8": dict(residency="paged", budget_bytes=1 << 22,
                       precision="int8"),
    "int8": dict(precision="int8"),
}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("knobs", SHARDED.values(), ids=list(SHARDED))
def test_sharded_engine_matches_unsharded_and_jax(knobs, n):
    """Sharded tokens equal the unsharded engine's (of the same precision)
    and the JAX sharded engine's; prefill logits within 1e-5 of JAX; the
    same shard decisions and per-shard runs; paged workers page their
    slices under their own budget share."""
    ref = RelationalEngine(T_SPEC, PARAMS, chunk_size=CS, max_len=8,
                           device="cpu",
                           precision=knobs.get("precision", "f32"))
    je, te = _engines(shards=n, **knobs)
    assert te.decode_pipe.shard_plan is not None
    assert [(d.table, d.kind, d.ranges)
            for d in te.decode_pipe.shard_plan.decisions] == \
        [(d.table, d.kind, d.ranges)
         for d in je.decode_pipe.shard_plan.decisions]
    np.testing.assert_allclose(te.start_session([3, 17, 42])["logits"],
                               je.start_session([3, 17, 42])["logits"],
                               rtol=1e-5, atol=1e-5)
    got = _tokens(te)
    assert got == _tokens(ref) == _tokens(je)
    stats = te.shard_pool.stats
    assert stats.sites == je.shard_pool.stats.sites > 0
    assert stats.fanout_s >= stats.critical_s > 0
    if knobs.get("residency") == "paged":
        budget = knobs["budget_bytes"] // n
        for w in te.shard_pool.workers:
            assert w.pager is not None and w.pager.stats.misses > 0
            assert w.pager.budget == budget
            assert w.pager.stats.peak_bytes <= budget
    te.shard_pool.shutdown()
    je.shard_pool.shutdown()


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_k1_calls_count_one_a_shard(n):
    """Each sharded site runs K1 once a shard: a sharded pipeline call
    makes one more K1 call a site than the unsharded one for each extra
    shard the site's key splits into (the planner clamps N to the key's
    size), and the workers run equally often."""
    ref = RelationalEngine(T_SPEC, PARAMS, chunk_size=CS, max_len=8,
                           device="cpu")
    eng = RelationalEngine(T_SPEC, PARAMS, chunk_size=CS, max_len=8,
                           device="cpu", shards=n)
    counts = []
    for e in (ref, eng):
        before = chunked_matmul.calls
        _tokens(e)
        counts.append(chunked_matmul.calls - before)
    runs = [w.metrics.counter("shard_worker_runs_total").value
            for w in eng.shard_pool.workers]
    sites = eng.shard_pool.stats.sites
    assert sites > 0 and runs[0] == runs[1] == sites
    assert counts[1] - counts[0] == sum(runs) - sites
    eng.shard_pool.shutdown()


def test_sharded_batched_decoder_matches_jax():
    je, te = _engines(shards=2, max_len=16)
    jd, td = je.batched_decoder(3, prefix_block=0), te.batched_decoder(3)
    last = {}
    for s, p in enumerate(([1, 2, 3], [4, 5, 6, 7], [9])):
        last[s] = jd.prefill(p, s)
        assert td.prefill(p, s) == last[s]
    for _ in range(3):
        ids = sorted(last)
        toks = jd.decode(ids, [last[s] for s in ids])
        assert td.decode(ids, [last[s] for s in ids]) == toks
        last = dict(zip(ids, toks))
    te.shard_pool.shutdown()
    je.shard_pool.shutdown()


def test_shards_validation():
    with pytest.raises(ValueError):
        RelationalEngine(T_SPEC, PARAMS, chunk_size=CS, max_len=8,
                         device="cpu", shards=0.5)
    eng = RelationalEngine(T_SPEC, PARAMS, chunk_size=CS, max_len=8,
                           device="cpu", shards=1)
    assert eng.shard_pool is None and eng.decode_pipe.shard_plan is None
    auto = RelationalEngine(T_SPEC, PARAMS, chunk_size=CS, max_len=8,
                            device="cpu", shards="auto")
    assert auto.shards >= 1
    if auto.shard_pool is not None:
        auto.shard_pool.shutdown()


# -- TestShardObservability, the metrics half ---------------------------------


def test_merged_metrics():
    reg = MetricsRegistry()
    eng = RelationalEngine(T_SPEC, PARAMS, chunk_size=CS, max_len=8,
                           device="cpu", shards=2, metrics=reg)
    _tokens(eng, steps=2)
    eng.merge_shard_metrics()
    dump = reg.to_dict()
    runs = {e["labels"]["shard"]: e["value"]
            for e in dump["shard_worker_runs_total"]}
    assert set(runs) == {"0", "1"}
    assert runs["0"] == runs["1"] == eng.shard_pool.stats.sites > 0
    busy = [e for e in dump["shard_worker_busy_seconds"]
            if e["labels"].get("shard") == "0"]
    assert busy and busy[0]["count"] == runs["0"]
    # tracing is off: the merged trace has no events, as the reference's
    assert eng.merged_shard_trace() == {"displayTimeUnit": "ms",
                                        "traceEvents": []}
    eng.shard_pool.shutdown()


def test_unsharded_engine_has_no_shard_surface():
    eng = RelationalEngine(T_SPEC, PARAMS, chunk_size=CS, max_len=8,
                           device="cpu")
    eng.merge_shard_metrics()  # no-op, must not raise
    assert eng.merged_shard_trace() is None


def test_tracing_raises_naming_n6():
    """Named for what it pinned before the tracer was ported (shard
    tracing raised naming N6); it now holds the traced shard pool to the
    reference's (``TestShardObservability::test_merged_metrics_and_trace``
    and the JAX engine's merged trace): ``ShardWorkerPool(trace=True)``
    gives each worker a recorder, each per-shard plan copy one
    ``"{step}::shard{s}"`` span (``cat="shard"``) carrying the
    coordinator's request ids, and ``merged_shard_trace`` puts the
    coordinator on pid 1 and each worker on its own pid, with the same
    events as the JAX engine's."""
    traces, toks = [], []
    for eng_cls, obs, kw in ((JEngine, jobs, {}),
                             (RelationalEngine, tobs, {"device": "cpu"})):
        tracer = obs.TraceRecorder()
        spec = J_SPEC if eng_cls is JEngine else T_SPEC
        eng = eng_cls(spec, PARAMS, chunk_size=CS, max_len=8, shards=2,
                      tracer=tracer, **kw)
        with obs.activate(obs.TraceContext.for_request(5, "ef" * 8)):
            toks.append(_tokens(eng, steps=2))
        merged = eng.merged_shard_trace()
        traces.append(sorted(
            (e["name"], e["cat"], e["pid"], e["tid"],
             sorted((k, str(v)) for k, v in e["args"].items()))
            for e in merged["traceEvents"]))
        eng.shard_pool.shutdown()
    assert toks[0] == toks[1] and traces[0] == traces[1]
    assert {e[2] for e in traces[1]} == {1, 2, 3}
    shard = [e for e in traces[1] if e[1] == "shard"]
    assert shard and {dict(e[4])["track"] for e in shard} == {"shard0",
                                                              "shard1"}
    assert all(dict(e[4])["rids"] == "[5]" for e in shard)
    pool = ShardWorkerPool(2, trace=True, device="cpu")
    assert all(w.tracer is not None for w in pool.workers)
    assert pool.merged_chrome_trace() == {"displayTimeUnit": "ms",
                                          "traceEvents": []}
    pool.shutdown()


def test_k1_counts_hold_under_concurrent_callers():
    """The shard workers call K1's wrapper from several threads at once:
    its counts lose no update with more threads than cores and a short
    switch interval."""
    x, w = torch.ones(1, 4), torch.ones(2, 4)
    before = chunked_matmul.calls
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [chunked_matmul(x, w) for _ in range(200)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert chunked_matmul.calls - before == 16 * 200
