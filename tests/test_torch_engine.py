"""The port's serving engine against the JAX package's.

``RelationalEngine.generate``, ``BatchedDecoder`` and a preempting
``ContinuousBatcher`` run over the same numpy weights in both packages and
must produce identical tokens; prefill logits agree within 1e-5.  Both
engines take the reference's defaults, so every pipeline is planned
(``row2col="auto"``, ``cache_layout="auto"``); the planner's other knobs
are held to the JAX engine's one by one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.llama_graph import (LlamaSpec as JSpec,  # noqa: E402
                                    init_llama_params)
from repro.obs import TraceRecorder as JTracer  # noqa: E402
from repro.serving.engine import RelationalEngine as JEngine  # noqa: E402
from repro.serving.kvcache import (PagedKVCache as JPaged,  # noqa: E402
                                   PagedKVConfig as JPagedCfg)
from repro.serving.scheduler import (ContinuousBatcher as JBatcher,  # noqa: E402
                                     Request as JRequest)
from repro_torch.core.llama_graph import (LlamaSpec,  # noqa: E402
                                          init_llama_tensors)
from repro_torch.kernels import chunked_matmul  # noqa: E402
from repro_torch.obs import TraceRecorder as TTracer  # noqa: E402
from repro_torch.serving.engine import RelationalEngine  # noqa: E402
from repro_torch.serving.kvcache import (PagedKVCache,  # noqa: E402
                                         PagedKVConfig)
from repro_torch.serving.scheduler import (ContinuousBatcher,  # noqa: E402
                                           Request)

SPEC_ARGS = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv=2,
                 d_ff=64, rope_theta=10000.0)
J_SPEC, T_SPEC = JSpec(**SPEC_ARGS), LlamaSpec(**SPEC_ARGS)
PARAMS = init_llama_params(J_SPEC, seed=0)


def _engines(cs=8, max_len=32):
    return (JEngine(J_SPEC, PARAMS, chunk_size=cs, max_len=max_len),
            RelationalEngine(T_SPEC, PARAMS, chunk_size=cs, max_len=max_len,
                             device="cpu"))


@pytest.mark.parametrize("cs", [4, 8, 16])
def test_generate_matches_jax(cs):
    je, te = _engines(cs)
    prompt = [3, 17, 42, 5, 9, 60]
    np.testing.assert_allclose(te.start_session(prompt)["logits"],
                               je.start_session(prompt)["logits"],
                               rtol=1e-5, atol=1e-5)
    assert te.generate(prompt, 8).tokens == je.generate(prompt, 8).tokens


def test_batched_decoder_matches_jax():
    """Ragged lengths, B = 3 padded to the bucket of 4, a slot freed and
    reused mid-stream."""
    je, te = _engines()
    jd, td = je.batched_decoder(4, prefix_block=0), te.batched_decoder(4)
    prompts = {0: [1, 2, 3], 1: [4, 5, 6, 7, 8, 9], 2: [10, 11]}
    last = {}
    for s, p in prompts.items():
        last[s] = jd.prefill(p, s)
        assert td.prefill(p, s) == last[s]
    for step in range(4):
        ids = sorted(last)
        toks = jd.decode(ids, [last[s] for s in ids])
        assert td.decode(ids, [last[s] for s in ids]) == toks
        last = dict(zip(ids, toks))
        if step == 1:  # sequence 1 leaves, a new one takes its slot
            jd.free(1)
            td.free(1)
            last[1] = jd.prefill([7, 7, 7, 7], 1)
            assert td.prefill([7, 7, 7, 7], 1) == last[1]
    assert td.decode_calls == jd.decode_calls == 4


def _serve(engine, paged, cfg, batcher, request, **dec_kwargs):
    """Five requests shaped as ``examples/serve_paged.py``, with a page pool
    small enough to preempt."""
    kv = paged(cfg(n_layers=2, n_kv=2, head_dim=8, page_size=4, n_pages=12,
                   max_pages_per_seq=8), max_seqs=4, **dec_kwargs.pop("kv"))
    dec = engine.batched_decoder(max_seqs=4, **dec_kwargs)

    def prefill(req, seq_id):
        ctx = req.context
        kv.ensure_capacity(seq_id, len(ctx))
        return dec.prefill(ctx, seq_id)

    sched = batcher(kv, prefill, dec.decode, max_batch=3,
                    release_fn=dec.free)
    rng = np.random.default_rng(0)
    for r in range(5):
        sched.submit(request(rid=r, prompt=[int(t) for t in rng.integers(
            0, SPEC_ARGS["vocab"], 8 + 4 * r)], max_new_tokens=4))
    done = sched.run()
    return {r.rid: r.generated for r in done}, sched.stats


def test_continuous_batcher_matches_jax_under_preemption():
    je, te = _engines()
    want, jstats = _serve(je, JPaged, JPagedCfg, JBatcher, JRequest,
                          prefix_block=0, kv={})
    calls = chunked_matmul.calls
    got, tstats = _serve(te, PagedKVCache, PagedKVConfig, ContinuousBatcher,
                         Request, kv={"device": "cpu"})
    assert got == want and len(got) == 5
    assert all(len(g) == 4 for g in got.values())
    assert tstats.preemptions == jstats.preemptions > 0
    pipeline_calls = tstats.prefills + tstats.decode_steps
    assert chunked_matmul.calls - calls == (
        7 * SPEC_ARGS["n_layers"] + 1) * pipeline_calls


def test_cuda_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RelationalEngine(T_SPEC, PARAMS, chunk_size=8, max_len=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedKVCache(PagedKVConfig(n_layers=1, n_kv=1, head_dim=4), 1)


def span_key(e):
    """A span's name, category, depth and args (values as text)."""
    return (e.name, e.cat, e.depth,
            tuple(sorted((k, str(v)) for k, v in e.args.items())))


def jax_twins(tracer):
    """The port's spans that the JAX engine records too: all but the
    ``device_wait`` spans around the host's reads of the logits (the
    reference's host read is not a span)."""
    return [e for e in tracer.events if e.name != "device_wait"]


@pytest.mark.parametrize("knob", [dict(tracer=True)])
def test_unported_knobs_raise(knob):
    """Named for what it pinned before every knob was ported (the last,
    ``tracer``, raised naming N6).  No knob raises now: the engine with a
    ``TraceRecorder`` generates the JAX engine's tokens and records the
    JAX engine's spans (the plan compile, ``session_env``, one
    ``cat="step"`` span a pipeline step with its ``kind``, ``ops`` and
    ``tables``, and the executor's ``cat="op"`` spans) in the same
    order."""
    assert knob == dict(tracer=True)
    jt, tt = JTracer(), TTracer()
    je = JEngine(J_SPEC, PARAMS, chunk_size=8, max_len=16, tracer=jt)
    te = RelationalEngine(T_SPEC, PARAMS, chunk_size=8, max_len=16,
                          device="cpu", tracer=tt)
    assert te.tracer is tt
    prompt = [3, 17, 42, 5]
    assert te.generate(prompt, 4).tokens == je.generate(prompt, 4).tokens
    assert [span_key(e) for e in jax_twins(tt)] == [
        span_key(e) for e in jt.events]
    steps = [e.name for e in tt.events if e.cat == "step"]
    assert steps == [s.name for s in te._prefill_pipe(4).steps] + 3 * [
        s.name for s in te.decode_pipe.steps]


COST = dict(row_weight=1.0, group_weight=0.05, seek_weight=2.0)
PLANNED_KNOBS = {
    "row2col": dict(row2col="col"),
    "cache_layout": dict(cache_layout="head_major", row2col="off"),
    "chunk_size": dict(chunk_size="auto", chunk_candidates=(4, 8, 16)),
    "cost_params": dict(cost_params=COST),
    "precision": dict(precision="int8"),
    "accuracy_budget": dict(precision="nf4", accuracy_budget=2.0),
    "table_precisions": dict(precision="auto",
                             table_precisions={"lm_head": "int8"}),
}


@pytest.mark.parametrize("knob", PLANNED_KNOBS.values(),
                         ids=list(PLANNED_KNOBS))
def test_planned_knobs_match_jax(knob):
    """Each planner knob the reference takes, through both engines: the
    same plan decisions, payload choices and resolved cache layout,
    prefill logits within 1e-5 and identical tokens, single-sequence and
    batched, with every matmul on K1."""
    from repro.planner import CostParams as JCost
    from repro_torch.planner import CostParams as TCost
    kw = dict(dict(chunk_size=8, max_len=24), **knob)
    jkw, tkw = dict(kw), dict(kw, device="cpu")
    if "cost_params" in kw:
        jkw["cost_params"], tkw["cost_params"] = JCost(**COST), TCost(**COST)
    je, te = JEngine(J_SPEC, PARAMS, **jkw), RelationalEngine(T_SPEC, PARAMS,
                                                               **tkw)
    assert (te.cs, te.cache_layout) == (je.cs, je.cache_layout)
    assert te.table_precision_choices == je.table_precision_choices
    jplan, tplan = je.decode_pipe.layout_plan, te.decode_pipe.layout_plan
    assert [(d.table, d.layout, d.physical_chunk) for d in tplan.decisions] \
        == [(d.table, d.layout, d.physical_chunk) for d in jplan.decisions]
    prompt = [3, 17, 42, 5, 9, 60]
    np.testing.assert_allclose(te.prefill_logits(prompt),
                               je.prefill_logits(prompt), rtol=1e-5,
                               atol=1e-5)
    calls = chunked_matmul.calls
    assert te.generate(prompt, 5).tokens == je.generate(prompt, 5).tokens
    assert chunked_matmul.calls - calls == 5 * (7 * SPEC_ARGS["n_layers"] + 1)
    jd, td = je.batched_decoder(2), te.batched_decoder(2)
    jlast = [jd.prefill([1, 2, 3], 0), jd.prefill([4, 5], 1)]
    tlast = [td.prefill([1, 2, 3], 0), td.prefill([4, 5], 1)]
    assert tlast == jlast
    for _ in range(3):
        jlast, tlast = jd.decode([0, 1], jlast), td.decode([0, 1], tlast)
        assert tlast == jlast
    assert td.pool.tables["k_cache_L0"].key_names == \
        jd.pool.tables["k_cache_L0"].key_names


def test_default_engine_is_planned_as_jax():
    """The reference's defaults, ``row2col="auto"`` and
    ``cache_layout="auto"``: the same resolved layouts in both engines, and
    session caches, slot pools and prefill plans in that one layout."""
    je, te = _engines()
    assert te.row2col == je.row2col == "auto"
    assert te.cache_layout == je.cache_layout
    assert te.decode_pipe.layout_plan.col_decisions
    sess = te.start_session([1, 2, 3])
    pool = te.batched_decoder(2).pool
    for name in ("k_cache_L0", "v_cache_L1"):
        order = te.decode_pipe.layout_plan.cache_decisions[0].key_order
        assert sess["env"][name].key_names == order
        assert pool.tables[name].key_names == ("seq",) + order
    prefill = te._prefill_pipe(3).layout_plan
    assert {d.layout for d in prefill.cache_decisions} == {te.cache_layout}


def test_replan_between_ticks_keeps_tokens():
    """``replan`` under other cost weights between two decode ticks: the
    cache layout, chunk sizes and precisions stay pinned, so the batched
    decoder goes on with the JAX decoder's tokens."""
    from repro_torch.planner import CostParams
    je, te = _engines()
    jd, td = je.batched_decoder(2, prefix_block=0), te.batched_decoder(2)
    last = [jd.prefill([1, 2, 3], 0), jd.prefill([4, 5, 6, 7], 1)]
    assert [td.prefill([1, 2, 3], 0), td.prefill([4, 5, 6, 7], 1)] == last
    layout = te.cache_layout
    for step in range(4):
        if step == 2:
            te.replan(CostParams(group_weight=10.0))
            assert te.replans == 1 and te.cache_layout == layout
        want = jd.decode([0, 1], last)
        assert td.decode([0, 1], last) == want
        last = want


def test_prefill_logits_match_jax():
    je, te = _engines()
    for prompt in ([5], [3, 17, 42, 5, 9, 60, 1, 2]):
        np.testing.assert_allclose(te.prefill_logits(prompt),
                                   je.prefill_logits(prompt), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("knob", [
    dict(row2col="yes"), dict(cache_layout="col_major"),
    dict(precision="fp8")])
def test_bad_knob_values_raise_value_error(knob):
    """The reference asserts on a knob value outside its vocabulary; the
    port raises ``ValueError`` naming the choices."""
    with pytest.raises(ValueError, match="must be one of"):
        RelationalEngine(T_SPEC, PARAMS, chunk_size=8, max_len=16,
                         device="cpu", **knob)
    with pytest.raises(AssertionError):
        JEngine(J_SPEC, PARAMS, chunk_size=8, max_len=16, **knob)


def test_prefix_block_16_serves():
    """The reference's default decoder, ``prefix_block=16``: a second
    prompt sharing a 16-token block with the first admits as a hit at
    boundary 16, and both decode the tokens of the JAX package's decoder."""
    je, te = _engines(max_len=40)
    jd, td = je.batched_decoder(2), te.batched_decoder(2)
    assert td.prefix_cache.block == 16 and td.prefix_bind == "auto"
    shared = list(range(3, 19))
    last = []
    for s, (p, cached) in enumerate(((shared + [1, 2], 0),
                                     (shared + [7, 8, 9], 16))):
        want = jd.prefill_ex(p, s)
        assert td.prefill_ex(p, s) == want and want[1] == cached
        last.append(want[0])
    assert td.prefix_cache.stats.hits == 1
    for _ in range(3):
        want = jd.decode([0, 1], last)
        assert td.decode([0, 1], last) == want
        last = want


def test_tracer_raises_naming_n6():
    """Named for what it pinned before the tracer was ported (it raised
    naming N6).  Now: a traced suffix session over a cached prefix and a
    traced batched decode tick record the JAX engine's spans (the
    decoder's ``cache_views`` / ``cache_writeback`` / ``logits_argmax``
    among them), their logits equal the untraced engine's bit for bit,
    and an unsharded engine has no merged shard trace."""
    jt, tt = JTracer(), TTracer()
    je = JEngine(J_SPEC, PARAMS, chunk_size=8, max_len=32, tracer=jt)
    te = RelationalEngine(T_SPEC, PARAMS, chunk_size=8, max_len=32,
                          device="cpu", tracer=tt)
    plain = RelationalEngine(T_SPEC, PARAMS, chunk_size=8, max_len=32,
                             device="cpu")
    prefix, prompt = [1, 2, 3, 4, 5, 6, 7, 8], [1, 2, 3, 4, 5, 6, 7, 8, 9]

    def caches(eng):
        return {k: v for k, v in eng.start_session(prefix)["env"].items()
                if k.startswith(("k_cache", "v_cache"))}
    jc, tc, pc = caches(je), caches(te), caches(plain)
    jt.clear()
    tt.clear()
    got = te.start_suffix_session(prompt, 8, tc)
    je.start_suffix_session(prompt, 8, jc)
    assert np.array_equal(got["logits"], plain.start_suffix_session(
        prompt, 8, pc)["logits"])
    jd, td = je.batched_decoder(2, prefix_block=0), te.batched_decoder(
        2, prefix_block=0)
    last = [jd.prefill([4, 5, 6], s) for s in (0, 1)]
    assert [td.prefill([4, 5, 6], s) for s in (0, 1)] == last
    assert td.decode([0, 1], last) == jd.decode([0, 1], last)
    assert [span_key(e) for e in jax_twins(tt)] == [
        span_key(e) for e in jt.events]
    assert {"cache_views", "cache_writeback", "logits_argmax",
            "cache_fill"} <= {e.name for e in tt.events
                              if e.cat == "decoder"}
    assert te.merged_shard_trace() is None


def test_init_llama_tensors_shapes_and_scales():
    spec = LlamaSpec(vocab=96, d_model=64, n_layers=2, n_heads=4, n_kv=2,
                     d_ff=128)
    got = init_llama_tensors(spec, seed=3, device="cpu")
    want = init_llama_params(JSpec(**vars(spec)), seed=3)
    assert list(got) == list(want)
    for name, arr in want.items():
        t = got[name]
        assert tuple(t.shape) == arr.shape and t.dtype == torch.float32
        if name.endswith("Norm") or "_Norm_" in name:
            assert torch.equal(t, torch.ones_like(t))
        else:
            assert abs(t.std().item() / arr.std() - 1) < 0.1, name
    again = init_llama_tensors(spec, seed=3, device="cpu")
    assert all(torch.equal(got[n], again[n]) for n in got)


def test_engine_runs_from_device_tensors():
    """Parameters given as tensors (as the GPU smoke run draws them) are
    wrapped without a host round trip and generate like numpy ones."""
    params = {k: torch.from_numpy(v.copy()) for k, v in PARAMS.items()}
    te = RelationalEngine(T_SPEC, params, chunk_size=8, max_len=16,
                          device="cpu")
    assert te.env_base["lm_head"].cols["chunk"].data_ptr() == \
        params["lm_head"].data_ptr()
    ref = RelationalEngine(T_SPEC, PARAMS, chunk_size=8, max_len=16,
                           device="cpu")
    assert te.generate([1, 2, 3], 4).tokens == ref.generate([1, 2, 3],
                                                             4).tokens
