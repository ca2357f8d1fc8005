"""The port's serving engine against the JAX package's.

``RelationalEngine.generate``, ``BatchedDecoder`` and a preempting
``ContinuousBatcher`` run over the same numpy weights in both packages and
must produce identical tokens; prefill logits agree within 1e-5.  The JAX
engine runs unplanned (``row2col="off"``, ``cache_layout="off"``), the
configuration the port implements.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.llama_graph import (LlamaSpec as JSpec,  # noqa: E402
                                    init_llama_params)
from repro.serving.engine import RelationalEngine as JEngine  # noqa: E402
from repro.serving.kvcache import (PagedKVCache as JPaged,  # noqa: E402
                                   PagedKVConfig as JPagedCfg)
from repro.serving.scheduler import (ContinuousBatcher as JBatcher,  # noqa: E402
                                     Request as JRequest)
from repro_torch.core.llama_graph import (LlamaSpec,  # noqa: E402
                                          init_llama_tensors)
from repro_torch.kernels import chunked_matmul  # noqa: E402
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
    return (JEngine(J_SPEC, PARAMS, chunk_size=cs, max_len=max_len,
                    row2col="off", cache_layout="off"),
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


@pytest.mark.parametrize("knob", [
    dict(row2col="auto"), dict(cache_layout="head_major"),
    dict(chunk_size="auto"), dict(cost_params=object()),
    dict(precision="int8"), dict(residency="paged"),
    dict(accuracy_budget=0.1), dict(metrics=object()),
    dict(tracer=object()), dict(shards=2)])
def test_unported_knobs_raise(knob):
    kwargs = dict(chunk_size=8, max_len=16, device="cpu")
    kwargs.update(knob)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        RelationalEngine(T_SPEC, PARAMS, **kwargs)


def test_prefix_cache_raises():
    te = RelationalEngine(T_SPEC, PARAMS, chunk_size=8, max_len=16,
                          device="cpu")
    with pytest.raises(NotImplementedError, match="N2"):
        te.batched_decoder(2, prefix_block=16)


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
