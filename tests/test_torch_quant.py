"""The port's quantised payloads against the JAX package's.

The codecs' codes and scales must be bit-identical to the reference's
(int8: ``absmax / 127`` then ``round(x / scale)``, half to even; nf4: the
count of midpoints below ``x / scale``), including values that sit exactly
on a midpoint or on a .5 tie; packing, the byte model and the quantised
SQL are the reference's; engines with ``precision`` and
``table_precisions`` generate the JAX engine's tokens, choose the same
tables, and the accuracy gate passes and refuses where the reference's
does.  All on the CPU, on numpy data from a seed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import llama_graph as jlg  # noqa: E402
from repro.quant import codecs as jcod, gate as jgate  # noqa: E402
from repro.quant import sql as jsql  # noqa: E402
from repro.serving.engine import RelationalEngine as JEngine  # noqa: E402
from repro_torch.core import llama_graph as tlg  # noqa: E402
from repro_torch.kernels import chunked_matmul  # noqa: E402
from repro_torch.quant import codecs as tcod, gate as tgate  # noqa: E402
from repro_torch.quant import sql as tsql  # noqa: E402
from repro_torch.serving.engine import RelationalEngine  # noqa: E402

SPEC_ARGS = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv=2,
                 d_ff=64, rope_theta=10000.0)
J_SPEC, T_SPEC = jlg.LlamaSpec(**SPEC_ARGS), tlg.LlamaSpec(**SPEC_ARGS)
PARAMS = jlg.init_llama_params(J_SPEC, seed=0)
CODECS = ("int8", "nf4")


def _ties() -> np.ndarray:
    """Groups whose normalised values land exactly on the decision
    boundaries: every nf4 midpoint (absmax 1, so x / scale is the f32
    midpoint itself) and every .5 tie of int8 (absmax 127, scale 1)."""
    mid = np.asarray(jcod.NF4_MIDPOINTS, np.float32)
    nf4 = np.concatenate([mid, -mid, [1.0]]).astype(np.float32)
    halves = np.arange(-126.5, 127.0, 1.0, dtype=np.float32)
    int8 = np.concatenate([halves, [127.0]]).astype(np.float32)
    width = max(len(nf4), len(int8))
    out = np.zeros((2, width), np.float32)
    out[0, :len(nf4)] = nf4
    out[1, :len(int8)] = int8
    return out


@pytest.mark.parametrize("name", CODECS)
@pytest.mark.parametrize("data", ["normal", "ties", "zeros", "wide"])
def test_codes_and_scales_bit_identical(name, data):
    rng = np.random.default_rng(7)
    arr = {"normal": rng.standard_normal((6, 5, 16)).astype(np.float32),
           "ties": _ties(),
           "zeros": np.zeros((3, 8), np.float32),
           "wide": (rng.standard_normal((4, 64)) * 1e3).astype(np.float32),
           }[data]
    jc, js = jcod.CODECS[name].quantise(arr)
    tc, ts = tcod.CODECS[name].quantise(torch.from_numpy(arr))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tcod.CODECS[name].dequantise(tc, ts).numpy(),
        np.asarray(jcod.CODECS[name].dequantise(jc, js)))


@pytest.mark.parametrize("name", CODECS)
@pytest.mark.parametrize("cs", [7, 8])
def test_pack_unpack_round_trip(name, cs):
    """Stored bytes equal the reference's (nf4: two codes a byte, a zero
    nibble tail at odd widths) and unpack back to the codes."""
    arr = np.random.default_rng(cs).standard_normal((5, 3, cs)).astype(
        np.float32)
    codec = tcod.CODECS[name]
    codes, _ = codec.quantise(torch.from_numpy(arr))
    packed = codec.pack(codes)
    np.testing.assert_array_equal(
        packed, jcod.CODECS[name].pack(np.asarray(
            jcod.CODECS[name].quantise(arr)[0])))
    assert torch.equal(codec.unpack(packed, cs), codes)
    assert torch.equal(codec.unpack(torch.from_numpy(packed), cs), codes)
    n = arr.size
    assert codec.table_bytes(n, n // cs) == \
        jcod.CODECS[name].table_bytes(n, n // cs)
    for prec in ("f32",) + CODECS:
        assert tcod.precision_bytes(prec, n, n // cs) == \
            jcod.precision_bytes(prec, n, n // cs)


@pytest.mark.parametrize("name", CODECS)
def test_table_and_dense_quantisation_match_jax(name):
    arr = np.random.default_rng(3).standard_normal((12, 20)).astype(
        np.float32)
    jt = jlg.convert_weights({"w": arr}, chunk_size=8)["w"]
    tt = tlg.convert_weights({"w": arr}, chunk_size=8, device="cpu")["w"]
    jq = jcod.quantise_chunked_table(jt, jcod.CODECS[name])
    tq = tcod.quantise_chunked_table(tt, tcod.CODECS[name])
    assert tq.keys == jq.keys and tq.col_types == jq.col_types
    for c in jq.cols:
        np.testing.assert_array_equal(tq.cols[c].numpy(),
                                      np.asarray(jq.cols[c]))
    for a, b in zip(tcod.quantise_dense(arr, 6, tcod.CODECS[name]),
                    jcod.quantise_dense(arr, 6, jcod.CODECS[name])):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(
        tcod.nf4_dequant_levels(torch.arange(16)).numpy(),
        np.asarray(jcod.nf4_dequant_levels(np.arange(16))))
    assert repr(tcod.quant_schema(tt.schema("w"))) == \
        repr(jcod.quant_schema(jt.schema("w")))


@pytest.mark.parametrize("name", CODECS)
def test_quantised_sql_matches_jax(name):
    sch = tlg.convert_weights({"w": np.zeros((4, 16), np.float32)},
                              chunk_size=8, device="cpu")["w"].schema("w")
    jsch = jlg.convert_weights({"w": np.zeros((4, 16), np.float32)},
                               chunk_size=8)["w"].schema("w")
    assert tsql.quant_ddl("w__q", tcod.quant_schema(sch), name) == \
        jsql.quant_ddl("w__q", jcod.quant_schema(jsch), name)
    for dialect in ("duckdb", "ansi"):
        assert tsql.quantise_conversion_sql("w", "w__q", name,
                                            sch.key_names, "chunk",
                                            dialect) == \
            jsql.quantise_conversion_sql("w", "w__q", name, jsch.key_names,
                                         "chunk", dialect)
    assert tsql.UDF_PRELUDE_QUANT_DUCKDB == jsql.UDF_PRELUDE_QUANT_DUCKDB


ENGINE_KNOBS = {
    "int8": dict(precision="int8"),
    "nf4": dict(precision="nf4"),
    "auto": dict(precision="auto"),
    "int8-col-pos": dict(precision="int8", row2col="col",
                         cache_layout="pos_major"),
    "tables": dict(precision="nf4",
                   table_precisions={"lm_head": "f32", "W1_L0": "int8"}),
}


@pytest.mark.parametrize("knobs", ENGINE_KNOBS.values(),
                         ids=list(ENGINE_KNOBS))
def test_quantised_engine_matches_jax(knobs):
    """Same quantised tables (the same codes), so the prefill logits agree
    within 1e-5 and the tokens exactly; every matmul still reaches K1
    after its dequant projection."""
    kw = dict(chunk_size=8, max_len=24, **knobs)
    je = JEngine(J_SPEC, PARAMS, **kw)
    te = RelationalEngine(T_SPEC, PARAMS, device="cpu", **kw)
    assert te.table_precision_choices == je.table_precision_choices
    if knobs["precision"] != "auto":
        assert te.table_precision_choices
    prompt = [3, 17, 42, 5, 9, 60]
    np.testing.assert_allclose(te.prefill_logits(prompt),
                               je.prefill_logits(prompt), rtol=1e-5,
                               atol=1e-5)
    calls = chunked_matmul.calls
    assert te.generate(prompt, 6).tokens == je.generate(prompt, 6).tokens
    assert chunked_matmul.calls - calls == 6 * (7 * J_SPEC.n_layers + 1)
    for q, table in te.env_base.items():
        if q.endswith(("__int8", "__nf4")):
            jt = je.env_base[q]
            for c in jt.cols:
                np.testing.assert_array_equal(table.cols[c].numpy(),
                                              np.asarray(jt.cols[c]))


@pytest.mark.parametrize("name,budget,passes", [
    ("int8", 0.5, True), ("nf4", 2.0, True), ("nf4", 1e-4, False),
    ("int8", 1e-7, False)])
def test_accuracy_gate_matches_jax(name, budget, passes):
    """The gate builds each package's own f32 engine and refuses the same
    budgets as the reference's."""
    kw = dict(chunk_size=8, max_len=16, precision=name,
              accuracy_budget=budget)
    outcomes = []
    for engine, spec, exc in (
            (JEngine, J_SPEC, jgate.AccuracyBudgetExceeded),
            (RelationalEngine, T_SPEC, tgate.AccuracyBudgetExceeded)):
        extra = {"device": "cpu"} if engine is RelationalEngine else {}
        try:
            engine(spec, PARAMS, **kw, **extra)
            outcomes.append(True)
        except exc:
            outcomes.append(False)
    assert outcomes == [passes, passes]


def test_gate_errors_match_jax():
    kw = dict(chunk_size=8, max_len=16)
    prompt = [4, 2, 9]
    for name in CODECS:
        got = tgate.max_logit_error(T_SPEC, PARAMS, name, prompt=prompt,
                                    device="cpu", **kw)
        want = jgate.max_logit_error(J_SPEC, PARAMS, name, prompt=prompt,
                                     **kw)
        assert got > 0
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        te = RelationalEngine(T_SPEC, PARAMS, precision=name, device="cpu",
                              **kw)
        ref = RelationalEngine(T_SPEC, PARAMS, device="cpu", **kw)
        assert tgate.check_accuracy(te, ref, prompt, tolerance=10.0) == \
            pytest.approx(got)
        with pytest.raises(tgate.AccuracyBudgetExceeded):
            tgate.check_accuracy(te, ref, prompt, tolerance=got / 2)
