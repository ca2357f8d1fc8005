"""The port's executor and pipeline runner against the JAX package's.

Every case builds its inputs with numpy from a seed, runs the same plan
through ``repro.core.executor`` and ``repro_torch.core.executor`` (each
package compiles with its own IR), and compares within rtol = atol = 1e-5
in float32.  The pipelines are the Llama prefill, decode and batched
decode plans of ``tests/test_llama_relational.py``'s spec at chunk sizes
4, 8 and 16.  The port runs each layer's attention subplan on one kernel
(``paged_attention`` for decode, ``flash_attention`` for prefill), here
through the kernels' plain versions; the JAX executor runs it relationally.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import executor as jex, llama_graph as jlg  # noqa: E402
from repro.core import relational as jra  # noqa: E402
from repro.core.chunked import ChunkedTensor as JChunked  # noqa: E402
from repro.core.graph import infer_shapes as j_infer  # noqa: E402
from repro.core.opmap import op_map as j_op_map  # noqa: E402
from repro.core.passes import (postoptimize as j_post,  # noqa: E402
                               preoptimize as j_pre)
from repro.core.pipeline import run_pipeline as j_run  # noqa: E402
from repro_torch.core import executor as tex, llama_graph as tlg  # noqa: E402
from repro_torch.core import relational as tra  # noqa: E402
from repro_torch.core.chunked import ChunkedTensor as TChunked  # noqa: E402
from repro_torch.core.graph import infer_shapes as t_infer  # noqa: E402
from repro_torch.core.opmap import op_map as t_op_map  # noqa: E402
from repro_torch.core.passes import (postoptimize as t_post,  # noqa: E402
                                     preoptimize as t_pre)
from repro_torch.core.pipeline import run_pipeline as t_run  # noqa: E402
from repro_torch.kernels import (chunked_matmul,  # noqa: E402
                                 flash_attention, paged_attention)

SPEC_ARGS = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv=2,
                 d_ff=64, rope_theta=10000.0)
J_SPEC, T_SPEC = jlg.LlamaSpec(**SPEC_ARGS), tlg.LlamaSpec(**SPEC_ARGS)
PARAMS = jlg.init_llama_params(J_SPEC, seed=0)
MAX_LEN = 16
CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cs", [4, 7, 8, 32])
def test_chunked_tensor_matches_jax(cs):
    """Same keys, schema and zero padding of the last chunk (7 and 32 do
    not divide the width 20)."""
    arr = np.random.default_rng(cs).standard_normal((3, 5, 20)).astype(
        np.float32)
    j = JChunked.from_dense("w", arr, chunk_size=cs)
    t = TChunked.from_dense("w", arr, chunk_size=cs, device="cpu")
    assert repr(j.schema) == repr(t.schema)
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))


# ---------------------------------------------------------------------------
# single-operator plans
# ---------------------------------------------------------------------------

PKGS = {
    "jax": (jra, jex, jnp.asarray),
    "torch": (tra, tex, lambda a: torch.from_numpy(np.array(a))),
}


def _run_case(build):
    """Run ``build(ra, table) -> (plan, env, scalars)`` in both packages."""
    outs = {}
    for name, (ra, ex, conv) in PKGS.items():
        def table(keys, cols, types, ex=ex, conv=conv):
            return ex.DenseTable(keys=tuple(keys),
                                 cols={c: conv(v) for c, v in cols.items()},
                                 col_types=dict(types))
        plan, env, scalars = build(ra, table)
        if name == "torch":
            scalars = {k: (torch.from_numpy(np.asarray(v, np.int64))
                           if np.ndim(v) else v) for k, v in scalars.items()}
        outs[name] = ex.execute(plan, env, scalars=scalars)
    return outs


RNG = np.random.default_rng(3)
X = RNG.standard_normal((6, 2, 8)).astype(np.float32)
W = RNG.standard_normal((5, 2, 8)).astype(np.float32)
Q = RNG.standard_normal((4, 8)).astype(np.float32)
KV = RNG.standard_normal((2, 8)).astype(np.float32)
S = RNG.standard_normal((3, 4)).astype(np.float32)


def case_gemm(ra, table):
    xt = table((("t", 6), ("c", 2)), {"v": X}, {"v": ra.VEC(8)})
    wt = table((("j", 5), ("c", 2)), {"chunk": W}, {"chunk": ra.VEC(8)})
    plan = ra.GroupAgg(
        input=ra.Join(left=ra.Scan("x", xt.schema()),
                      right=ra.Scan("w", wt.schema()),
                      on=[("c", ra.key("c"))]),
        group_keys=["t", "j"],
        aggs=[("s", "SUM", ra.call("dot", ra.col("v"), ra.col("chunk")))])
    return plan, {"x": xt, "w": wt}, {}


def case_gqa_join(ra, table):
    qt = table((("h", 4),), {"q": Q}, {"q": ra.VEC(8)})
    kt = table((("hk", 2),), {"k": KV}, {"k": ra.VEC(8)})
    plan = ra.GroupAgg(
        input=ra.Join(left=ra.Scan("q", qt.schema()),
                      right=ra.Scan("k", kt.schema()),
                      on=[("hk", ra.floordiv(ra.key("h"), ra.const(2)))]),
        group_keys=["h"],
        aggs=[("s", "SUM", ra.call("scale", ra.call("dot", ra.col("q"),
                                                    ra.col("k")),
                                   ra.const(0.25)))])
    return plan, {"q": qt, "k": kt}, {}


def case_unfused_join(ra, table):
    qt = table((("h", 4),), {"q": Q}, {"q": ra.VEC(8)})
    kt = table((("hk", 2),), {"k": KV}, {"k": ra.VEC(8)})
    plan = ra.Project(
        input=ra.Join(left=ra.Scan("q", qt.schema()),
                      right=ra.Scan("k", kt.schema()),
                      on=[("hk", ra.floordiv(ra.key("h"), ra.const(2)))]),
        keys=None, exprs=[("p", None, ra.mul(ra.col("q"), ra.col("k")))])
    return plan, {"q": qt, "k": kt}, {}


def case_filter_param(ra, table):
    t = table((("t", 3), ("tp", 4)), {"s": S}, {"s": ra.SCALAR})
    plan = ra.Filter(input=ra.Scan("t", t.schema()),
                     predicate=("<=", ra.key("tp"),
                                ra.add(ra.key("t"), ra.Param("pos"))),
                     masked_value=-1e30)
    return plan, {"t": t}, {"pos": 1}


def case_filter_keyparam(ra, table):
    t = table((("seq", 3), ("tp", 4)), {"s": S}, {"s": ra.SCALAR})
    plan = ra.Filter(input=ra.Scan("t", t.schema()),
                     predicate=("<=", ra.key("tp"),
                                ra.KeyParam("seq_positions", "seq")),
                     masked_value=-1e30)
    return plan, {"t": t}, {"seq_positions": np.array([0, 3, 1])}


def case_softmax(ra, table):
    t = table((("t", 3), ("tp", 4)), {"s": S}, {"s": ra.SCALAR})
    m = ra.GroupAgg(input=ra.Scan("t", t.schema()), group_keys=["t"],
                    aggs=[("m", "MAX", ra.col("s"))])
    j = ra.Join(left=ra.Scan("t", t.schema()), right=m,
                on=[("t", ra.key("t"))])
    e = ra.Project(input=j, keys=None, exprs=[
        ("ex", None, ra.call("exp", ra.sub(ra.col("s"), ra.col("m"))))])
    z = ra.GroupAgg(input=e, group_keys=["t"], aggs=[("z", "SUM",
                                                      ra.col("ex"))])
    p = ra.Project(input=ra.Join(left=e, right=z, on=[("t", ra.key("t"))]),
                   keys=None, exprs=[("p", None, ra.div(ra.col("ex"),
                                                        ra.col("z")))])
    return p, {"t": t}, {}


def case_unary_and_binary(ra, table):
    xt = table((("t", 6), ("c", 2)), {"v": X}, {"v": ra.VEC(8)})
    v = ra.col("v")
    exprs = [(f"u_{fn}", None, ra.call(fn, v))
             for fn in ("exp", "neg", "sigmoid", "silu", "gelu", "square",
                        "identity")]
    exprs += [("sq", None, ra.call("sqrt", ra.call("square", v))),
              ("rs", None, ra.call("rsqrt", ra.add(ra.call("square", v),
                                                    ra.const(1e-5)))),
              ("mx", None, ra.BinOp("max", v, ra.const(0.1))),
              ("mn", None, ra.BinOp("min", v, ra.const(0.1))),
              ("ks", None, ra.mul(v, ra.key("c"))),
              ("vs", None, ra.call("vsum", v)),
              ("fh", None, ra.call("first_half", v)),
              ("cat", None, ra.call("concat", ra.call("second_half", v),
                                    ra.call("first_half", v)))]
    plan = ra.Project(input=ra.Scan("x", xt.schema()), keys=None,
                      exprs=exprs)
    return plan, {"x": xt}, {}


def case_unnest_collect(ra, table):
    xt = table((("t", 6), ("c", 2)), {"v": X}, {"v": ra.VEC(8)})
    u = ra.Unnest(input=ra.Scan("x", xt.schema()), vec_col="v",
                  elem_key="e", elem_col="x")
    p = ra.Project(input=u, keys=[
        ("t", 6, ra.key("t")),
        ("d", 16, ra.add(ra.mul(ra.key("c"), ra.const(8)), ra.key("e")))],
        exprs=[("x", None, ra.col("x"))])
    p2 = ra.Project(input=p, keys=[
        ("t", 6, ra.key("t")),
        ("c", 4, ra.floordiv(ra.key("d"), ra.const(4))),
        ("e", 4, ra.mod(ra.key("d"), ra.const(4)))],
        exprs=[("x", None, ra.col("x"))])
    c = ra.Collect(input=p2, fold_key="e", scalar_col="x", vec_col="v")
    return c, {"x": xt}, {}


def case_group_reductions(ra, table):
    t = table((("t", 3), ("tp", 4)), {"s": S}, {"s": ra.SCALAR})
    plan = ra.GroupAgg(input=ra.Scan("t", t.schema()), group_keys=["tp"],
                       aggs=[("sum", "SUM", ra.col("s"))])
    plan2 = ra.GroupAgg(input=plan, group_keys=[],
                        aggs=[("avg", "AVG", ra.col("sum"))])
    return plan2, {"t": t}, {}


def case_value_join(ra, table):
    ids = table((("t", 3),), {"s": np.array([2, 0, 1], np.int32)},
                {"s": ra.SCALAR})
    vocab = table((("tok", 3), ("c", 1)),
                  {"chunk": np.eye(3, 8, dtype=np.float32)[:, None, :]},
                  {"chunk": ra.VEC(8)})
    plan = ra.Project(
        input=ra.Join(left=ra.Scan("ids", ids.schema()),
                      right=ra.Scan("vocab", vocab.schema()),
                      on=[("tok", ra.col("s"))]),
        keys=None, exprs=[("v", None, ra.col("chunk"))])
    return plan, {"ids": ids, "vocab": vocab}, {}


CASES = {f.__name__[5:]: f for f in (
    case_gemm, case_gqa_join, case_unfused_join, case_filter_param,
    case_filter_keyparam, case_softmax, case_unary_and_binary,
    case_unnest_collect, case_group_reductions, case_value_join)}


@pytest.mark.parametrize("case", list(CASES))
def test_single_plan_matches_jax(case):
    outs = _run_case(CASES[case])
    j, t = outs["jax"], outs["torch"]
    assert j.keys == t.keys and list(j.cols) == list(t.cols)
    for c in j.cols:
        np.testing.assert_allclose(t.cols[c].numpy(), np.asarray(j.cols[c]),
                                   err_msg=c, **TOL)


def _calls():
    return (chunked_matmul.calls, paged_attention.calls, flash_attention.calls)


def test_gemm_site_goes_to_the_kernel_and_attention_does_not():
    """A GEMM site runs K1; an isolated score join (no softmax or output
    join around it) is no attention subplan and calls neither K2 nor K3."""
    k1, k2, k3 = _calls()
    _run_case(case_gemm)
    assert _calls() == (k1 + 1, k2, k3)
    _run_case(case_gqa_join)
    assert _calls() == (k1 + 1, k2, k3)


def test_value_join_out_of_range_raises():
    def build(ra, table):
        plan, env, sc = case_value_join(ra, table)
        env["ids"] = table((("t", 3),), {"s": np.array([2, 3, 1], np.int32)},
                           {"s": ra.SCALAR})
        return plan, env, sc
    with pytest.raises(IndexError, match="leave"):
        _run_case(build)


# ---------------------------------------------------------------------------
# whole pipelines
# ---------------------------------------------------------------------------

_PIPES = {}


def _pipes(kind, cs, T=0, batch=0, max_len=MAX_LEN):
    """(jax pipeline, torch pipeline) for one graph, compiled once."""
    key = (kind, cs, T, batch, max_len)
    if key not in _PIPES:
        out = []
        for lg, spec, infer, pre, opm, post in (
                (jlg, J_SPEC, j_infer, j_pre, j_op_map, j_post),
                (tlg, T_SPEC, t_infer, t_pre, t_op_map, t_post)):
            g = (lg.build_prefill_graph(spec, T, cache_len=max_len)
                 if kind == "prefill" else
                 lg.build_decode_graph(spec, cache_len=max_len, batch=batch))
            infer(g)
            pre(g)
            pipe = opm(g, chunk_size=cs)
            post(pipe)
            out.append(pipe)
        _PIPES[key] = tuple(out)
    return _PIPES[key]


def _prefill_envs(cs, prompt, max_len=MAX_LEN):
    """Post-prefill environments of both packages (and the prefill logits)."""
    jp, tp = _pipes("prefill", cs, T=len(prompt), max_len=max_len)
    T = len(prompt)
    jenv = jlg.convert_weights(PARAMS, chunk_size=cs)
    jenv.update(jlg.empty_cache_tables(J_SPEC, max_len, chunk_size=cs))
    jenv["token_ids"] = jlg.token_table(np.asarray(prompt, np.int32))
    jenv["freq_each_token"] = jlg.rope_freq_table(
        np.arange(T), J_SPEC.head_dim, J_SPEC.rope_theta)
    tenv = tlg.convert_weights(PARAMS, chunk_size=cs, device="cpu")
    tenv.update(tlg.empty_cache_tables(T_SPEC, max_len, chunk_size=cs,
                                       device=CPU))
    tenv["token_ids"] = tlg.token_table(np.asarray(prompt), device=CPU)
    tenv["freq_each_token"] = tlg.rope_freq_table(
        np.arange(T), T_SPEC.head_dim, T_SPEC.rope_theta, device=CPU)
    jo, jenv = j_run(jp, jenv, scalars={"cache_position": 0})
    to, tenv = t_run(tp, tenv, scalars={"cache_position": 0})
    return jo, jenv, to, tenv


def _decode_inputs(jenv, tenv, tok, pos):
    jenv["token_ids"] = jlg.token_table(np.asarray([tok], np.int32))
    jenv["freq_each_token"] = jlg.rope_freq_table(
        np.asarray([pos]), J_SPEC.head_dim, J_SPEC.rope_theta)
    tenv["token_ids"] = tlg.token_table(np.asarray([tok]), device=CPU)
    tenv["freq_each_token"] = tlg.rope_freq_table(
        np.asarray([pos]), T_SPEC.head_dim, T_SPEC.rope_theta, device=CPU)


def _close(j_table, t_table):
    for c in j_table.cols:
        np.testing.assert_allclose(t_table.cols[c].numpy(),
                                   np.asarray(j_table.cols[c]), **TOL)


def _snapshot(env):
    return {n: {c: v.clone() for c, v in t.cols.items()}
            for n, t in env.items()}


def _unchanged(env, snap):
    return all(torch.equal(env[n].cols[c], v)
               for n, cols in snap.items() for c, v in cols.items())


N_LAYERS = SPEC_ARGS["n_layers"]
PER_CALL = 7 * N_LAYERS + 1


@pytest.mark.parametrize("cs", [4, 8, 16])
def test_prefill_pipeline_matches_jax(cs):
    k1, k2, k3 = _calls()
    jo, jenv, to, tenv = _prefill_envs(cs, [3, 17, 42, 5, 9])
    assert _calls() == (k1 + PER_CALL, k2, k3 + N_LAYERS)
    _close(jo["logits"], to["logits"])
    for name in ("k_cache_L0", "v_cache_L1"):
        _close(jenv[name], tenv[name])


@pytest.mark.parametrize("cs", [4, 8, 16])
def test_decode_pipeline_matches_jax(cs):
    jo, jenv, to, tenv = _prefill_envs(cs, [3, 17, 42])
    jd, td = _pipes("decode", cs)
    for pos in (3, 4):
        tok = int(np.argmax(np.asarray(jo["logits"].cols["v"]).reshape(
            -1, J_SPEC.vocab)[-1]))
        _decode_inputs(jenv, tenv, tok, pos)
        snap = _snapshot(tenv)
        k1, k2, k3 = _calls()
        jo, jenv = j_run(jd, jenv, scalars={"cache_position": pos})
        to, tenv_new = t_run(td, tenv, scalars={"cache_position": pos})
        assert _calls() == (k1 + PER_CALL, k2 + N_LAYERS, k3)
        assert _unchanged(tenv, snap), "run_pipeline wrote the caller's env"
        tenv = tenv_new
        _close(jo["logits"], to["logits"])
        _close(jenv["k_cache_L1"], tenv["k_cache_L1"])


def _batched_envs(cs, prompts, bucket, max_len=MAX_LEN):
    """Seq-keyed batched envs with each prompt's prefill in its slot."""
    jenv = jlg.convert_weights(PARAMS, chunk_size=cs)
    tenv = tlg.convert_weights(PARAMS, chunk_size=cs, device="cpu")
    jenv.update(jlg.empty_cache_tables(J_SPEC, max_len, chunk_size=cs,
                                       batch=bucket))
    tenv.update(tlg.empty_cache_tables(T_SPEC, max_len, chunk_size=cs,
                                       batch=bucket, device=CPU))
    toks = []
    for s, prompt in enumerate(prompts):
        jo, je, _, te = _prefill_envs(cs, prompt, max_len)
        jlg.copy_cache_slot(jenv, s, je)
        tlg.copy_cache_slot(tenv, s, te)
        toks.append(int(np.argmax(np.asarray(jo["logits"].cols["v"]).reshape(
            -1, J_SPEC.vocab)[-1])))
    positions = np.asarray([len(p) for p in prompts], np.int32)
    jenv["token_ids"] = jlg.token_table(np.asarray(toks, np.int32), key="seq")
    tenv["token_ids"] = tlg.token_table(np.asarray(toks), key="seq",
                                        device=CPU)
    jenv["freq_each_token"] = jlg.rope_freq_table(
        positions, J_SPEC.head_dim, J_SPEC.rope_theta, key="seq")
    tenv["freq_each_token"] = tlg.rope_freq_table(
        positions, T_SPEC.head_dim, T_SPEC.rope_theta, key="seq", device=CPU)
    return jenv, tenv, positions


@pytest.mark.parametrize("cs", [4, 8, 16])
def test_batched_decode_pipeline_matches_jax(cs):
    # three live sequences padded to the bucket by repeating the last
    jenv, tenv, positions = _batched_envs(
        cs, [[3, 17, 42], [5, 9], [1, 2, 3, 4, 5], [1, 2, 3, 4, 5]], bucket=4)
    jb, tb = _pipes("batched", cs, batch=4)
    snap = _snapshot(tenv)
    k1, k2, k3 = _calls()
    jo, jenv2 = j_run(jb, jenv, scalars={
        "seq_positions": jnp.asarray(positions, jnp.int32)})
    to, tenv2 = t_run(tb, tenv, scalars={"seq_positions": positions})
    assert _calls() == (k1 + PER_CALL, k2 + N_LAYERS, k3)
    assert _unchanged(tenv, snap), "run_pipeline wrote the caller's env"
    _close(jo["logits"], to["logits"])
    _close(jenv2["v_cache_L0"], tenv2["v_cache_L0"])


@pytest.mark.parametrize("T,max_len", [(5, 40), (17, 40), (5, 100),
                                       (17, 100)])
def test_ragged_prompts_and_cache_lengths_match_jax(T, max_len):
    """Prompt lengths that fill no kernel tile and caches that are not a
    multiple of 64 rows (the executor's page is gcd(max_len, 64): 8 and 4
    rows): prefill, two decode steps and one batched tick."""
    prompt = [int(t) for t in np.random.default_rng(T).integers(0, 64, T)]
    jo, jenv, to, tenv = _prefill_envs(8, prompt, max_len)
    _close(jo["logits"], to["logits"])
    jd, td = _pipes("decode", 8, max_len=max_len)
    for pos in (T, T + 1):
        tok = int(np.argmax(np.asarray(jo["logits"].cols["v"]).reshape(
            -1, J_SPEC.vocab)[-1]))
        _decode_inputs(jenv, tenv, tok, pos)
        k2 = paged_attention.calls
        jo, jenv = j_run(jd, jenv, scalars={"cache_position": pos})
        to, tenv = t_run(td, tenv, scalars={"cache_position": pos})
        assert paged_attention.calls == k2 + N_LAYERS
        _close(jo["logits"], to["logits"])
    jenv, tenv, positions = _batched_envs(8, [prompt, [5, 9]], bucket=2,
                                          max_len=max_len)
    jb, tb = _pipes("batched", 8, batch=2, max_len=max_len)
    jo, _ = j_run(jb, jenv, scalars={
        "seq_positions": jnp.asarray(positions, jnp.int32)})
    to, _ = t_run(tb, tenv, scalars={"seq_positions": positions})
    _close(jo["logits"], to["logits"])


@pytest.mark.parametrize("kind", ["prefill", "decode", "batched"])
def test_port_compiles_the_reference_pipeline(kind):
    jp, tp = _pipes(kind, 8, T=5, batch=2 if kind == "batched" else 0)
    assert [(s.kind, s.name, s.offset_name, s.append_key, s.seq_key)
            for s in jp.steps] == [(s.kind, s.name, s.offset_name,
                                    s.append_key, s.seq_key)
                                   for s in tp.steps]
    assert repr(jp.weight_schemas) == repr(tp.weight_schemas)
    assert repr(jp.input_schemas) == repr(tp.input_schemas)
    assert jp.cache_tables == tp.cache_tables and jp.outputs == tp.outputs


def test_append_at_last_position_matches_jax():
    jo, jenv, to, tenv = _prefill_envs(8, [3, 17, 42])
    jd, td = _pipes("decode", 8)
    _decode_inputs(jenv, tenv, 7, MAX_LEN - 1)
    jo, jenv = j_run(jd, jenv, scalars={"cache_position": MAX_LEN - 1})
    to, tenv = t_run(td, tenv, scalars={"cache_position": MAX_LEN - 1})
    _close(jo["logits"], to["logits"])
    _close(jenv["k_cache_L0"], tenv["k_cache_L0"])


def test_append_past_the_cache_raises_where_jax_clamps():
    jo, jenv, to, tenv = _prefill_envs(8, [3, 17, 42])
    jd, td = _pipes("decode", 8)
    _decode_inputs(jenv, tenv, 7, MAX_LEN)
    # the reference clamps the write to the last row and runs on
    jo, _ = j_run(jd, jenv, scalars={"cache_position": MAX_LEN})
    assert np.isfinite(np.asarray(jo["logits"].cols["v"])).all()
    with pytest.raises(IndexError, match="overflows the cache"):
        t_run(td, tenv, scalars={"cache_position": MAX_LEN})


def test_batched_append_past_the_cache_raises():
    _, tenv, positions = _batched_envs(8, [[3, 17], [5, 9, 2]], bucket=2)
    _, tb = _pipes("batched", 8, batch=2)
    with pytest.raises(IndexError, match="append positions"):
        t_run(tb, tenv, scalars={"seq_positions": np.array([2, MAX_LEN])})


def test_token_id_past_the_vocabulary_raises():
    tp = _pipes("prefill", 8, T=3)[1]
    tenv = tlg.convert_weights(PARAMS, chunk_size=8, device="cpu")
    tenv.update(tlg.empty_cache_tables(T_SPEC, MAX_LEN, chunk_size=8,
                                       device=CPU))
    tenv["token_ids"] = tlg.token_table(np.asarray([1, SPEC_ARGS["vocab"], 2]),
                                        device=CPU)
    tenv["freq_each_token"] = tlg.rope_freq_table(
        np.arange(3), T_SPEC.head_dim, T_SPEC.rope_theta, device=CPU)
    with pytest.raises(IndexError, match="token id"):
        t_run(tp, tenv, scalars={"cache_position": 0})
