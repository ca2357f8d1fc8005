"""The port's observability layer (``repro_torch.obs``) against the JAX
package's: span tracing, the DuckDB profile parser, statement provenance,
SQL timing under SQLite, the drift report, and traced pipelines and
engines.

Both packages take the same inputs (the same numpy weights, spans, step
times, profiles and statements) and must give equal results: equal span
names, order and args for a traced ``run_pipeline`` and engine (the op
spans too: a fused subplan's inner nodes are pipeline steps of their own,
so both executors visit the same nodes), equal drift reports and fits,
and equal attributions.  The reference's cases of ``tests/test_obs.py``
(all but the metrics registry's, which ``tests/test_torch_prefix.py``
runs on both registries) run on both packages.  The DuckDB case skips
without ``duckdb``, as ``tests/test_duckdb_e2e.py`` does.
"""

import dataclasses
import json
import os
import re
import sqlite3

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.obs as jobs  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro.core import llama_graph as jlg  # noqa: E402
from repro.core.graph import infer_shapes as j_infer  # noqa: E402
from repro.core.opmap import op_map as j_op_map  # noqa: E402
from repro.core.passes import postoptimize as j_post  # noqa: E402
from repro.core.passes import preoptimize as j_pre  # noqa: E402
from repro.core.pipeline import run_pipeline as j_run  # noqa: E402
from repro.core.sqlgen import (  # noqa: E402
    generate_sql_with_provenance as j_sql_prov)
from repro.planner.calibrate import (  # noqa: E402
    fit_from_step_timings as j_fit, step_features as j_features)
from repro.serving.engine import RelationalEngine as JEngine  # noqa: E402
from repro_torch.core import llama_graph as tlg  # noqa: E402
from repro_torch.core.executor import (plan_provenance,  # noqa: E402
                                       steps_provenance)
from repro_torch.core.graph import infer_shapes as t_infer  # noqa: E402
from repro_torch.core.opmap import op_map as t_op_map  # noqa: E402
from repro_torch.core.passes import postoptimize as t_post  # noqa: E402
from repro_torch.core.passes import preoptimize as t_pre  # noqa: E402
from repro_torch.core.pipeline import run_pipeline as t_run  # noqa: E402
from repro_torch.core.sqlgen import (  # noqa: E402
    generate_sql_with_provenance as t_sql_prov)
from repro_torch.obs.profile import (classify_eqp_detail,  # noqa: E402
                                     classify_operator, scanned_table)
from repro_torch.planner.calibrate import (  # noqa: E402
    fit_from_step_timings as t_fit, step_features as t_features)
from repro_torch.serving.engine import RelationalEngine  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
PACKAGES = [pytest.param(jobs, id="jax"), pytest.param(tobs, id="torch")]

# the reference's test spec, and a wider one for the engine cases
SPEC_ARGS = dict(vocab=16, d_model=8, n_layers=1, n_heads=2, n_kv=1,
                 d_ff=16, rope_theta=10000.0)
J_SPEC, T_SPEC = jlg.LlamaSpec(**SPEC_ARGS), tlg.LlamaSpec(**SPEC_ARGS)
PARAMS = jlg.init_llama_params(J_SPEC, seed=0)
CS = 4
WIDE_ARGS = dict(vocab=64, d_model=32, n_layers=1, n_heads=4, n_kv=2,
                 d_ff=64, rope_theta=10000.0)
WIDE_PARAMS = jlg.init_llama_params(jlg.LlamaSpec(**WIDE_ARGS), seed=0)


def _decode_pipes(**post_kw):
    """The reference's decode pipeline compiled by both packages."""
    out = []
    for lg, infer, pre, op_map, post in (
            (jlg, j_infer, j_pre, j_op_map, j_post),
            (tlg, t_infer, t_pre, t_op_map, t_post)):
        g = lg.build_decode_graph(lg.LlamaSpec(**SPEC_ARGS), cache_len=4)
        infer(g)
        pre(g)
        pipe = op_map(g, chunk_size=CS)
        post(pipe, **post_kw)
        out.append(pipe)
    return out


def span_key(e):
    """A span's name, category, depth and args (values as text), the
    fields both packages must agree on (times differ)."""
    return (e.name, e.cat, e.depth,
            tuple(sorted((k, str(v)) for k, v in e.args.items())))


def jax_twins(tracer):
    """The port's spans that the JAX engine records too: all but the
    ``device_wait`` spans around the host's reads of the logits (the
    reference's host read is not a span)."""
    return [e for e in tracer.events if e.name != "device_wait"]


# -- TestTraceRecorder --------------------------------------------------------


def _tick_clock():
    t = [0.0]

    def clock():
        t[0] += 0.001
        return t[0]
    return clock


@pytest.mark.parametrize("obs", PACKAGES)
def test_span_nesting_and_chrome_export(obs):
    rec = obs.TraceRecorder(clock=_tick_clock())
    with rec.span("outer", cat="step"):
        with rec.span("inner", cat="op"):
            pass
    assert {e.name: e.depth for e in rec.events} == {"outer": 0, "inner": 1}
    chrome = rec.to_chrome()
    assert all(ev["ph"] == "X" for ev in chrome["traceEvents"])
    assert chrome["traceEvents"][0]["name"] == "outer"


def test_recorders_agree_on_a_fixed_clock():
    """The same span program on a deterministic clock gives the same
    events, Chrome trace, drains and totals in both packages."""
    out = []
    for obs in (jobs, tobs):
        rec = obs.TraceRecorder(clock=_tick_clock())
        ctx = obs.TraceContext.for_request(7, "ab" * 8, phase="decode")
        with obs.activate(ctx):
            with rec.span("step_a", cat="step", kind="bind"):
                with rec.span("join", cat="op", tables=["w"]):
                    pass
            rec.add_span("pager_fetch:w", "pager", 5.0, 2.5, depth=1,
                         bytes=64)
        with rec.span("step_b", cat="step"):
            pass
        drained = rec.drain(1)
        out.append(([dataclasses.asdict(e) for e in rec.events],
                    [dataclasses.asdict(e) for e in drained],
                    rec.to_chrome(), rec.step_times_us(),
                    rec.total_us("op")))
    assert out[0] == out[1]


@pytest.mark.parametrize("obs", PACKAGES)
def test_step_times_sum_per_name(obs):
    rec = obs.TraceRecorder()
    rec.add_span("a", "step", 0, 100)
    rec.add_span("a", "step", 200, 50)
    rec.add_span("b", "step", 300, 10)
    rec.add_span("x", "op", 0, 999)
    assert rec.step_times_us() == {"a": 150.0, "b": 10.0}
    assert rec.total_us("op") == 999.0


# -- TestProfileParser --------------------------------------------------------


def _parsed(obs, fixture):
    with open(os.path.join(FIXTURES, fixture)) as f:
        return obs.parse_profile(f.read())


@pytest.mark.parametrize("fixture,total", [
    ("duckdb_profile_legacy.json", 0.0042),
    ("duckdb_profile_modern.json", 0.0051),
])
def test_both_key_formats_normalise(fixture, total):
    root = _parsed(tobs, fixture)
    assert root.operator == "QUERY"
    assert root.timing_s == pytest.approx(total)
    ops = {n.operator for n in tobs.flatten_profile(root)}
    assert {"PROJECTION", "HASH_JOIN", "HASH_GROUP_BY"} <= ops
    scans = [n for n in tobs.flatten_profile(root)
             if classify_operator(n.operator) == "scan"]
    assert {scanned_table(n) for n in scans} == {"W__col", "x_embed"}
    assert dataclasses.asdict(root) == dataclasses.asdict(
        _parsed(jobs, fixture))


def test_bare_operator_tree_gets_query_root():
    tree = {"name": "PROJECTION", "timing": 0.1, "cardinality": 1,
            "children": []}
    root = tobs.parse_profile(tree)
    assert root.operator == "QUERY" and len(root.children) == 1
    assert dataclasses.asdict(root) == dataclasses.asdict(
        jobs.parse_profile(tree))


def test_classify_refines_by_provenance():
    class Prov:
        kind = "append"
        quantised = ("lm_head",)
    assert classify_operator("PROJECTION") == "project"
    assert classify_operator("PROJECTION", Prov()) == "dequant_project"
    assert classify_operator("INSERT", Prov()) == "cache_append"
    assert classify_operator("TOTALLY_NEW_OP") == "other"


@pytest.mark.parametrize("obs", PACKAGES)
def test_attribution_and_coverage(obs):
    root = _parsed(obs, "duckdb_profile_modern.json")

    class Prov:
        kind = "bind"
        step = "linear_1"
        quantised = ()

    class NoStep:
        kind = "ddl"
        step = None
        quantised = ()
    attributed = obs.attribute_statement(root, Prov())
    assert all(a.step == "linear_1" for a in attributed)
    assert obs.coverage(attributed) == pytest.approx(1.0)
    assert obs.coverage(attributed, total_s=1.0) < 0.01
    mixed = attributed + obs.attribute_statement(root, NoStep())
    assert obs.coverage(mixed) == pytest.approx(0.5)


def test_attributions_match_jax():
    class Prov:
        kind = "bind"
        step = "linear_1"
        quantised = ("W__col",)
    got = [tobs.attribute_statement(_parsed(tobs, f), Prov())
           for f in ("duckdb_profile_legacy.json",
                     "duckdb_profile_modern.json")]
    want = [jobs.attribute_statement(_parsed(jobs, f), Prov())
            for f in ("duckdb_profile_legacy.json",
                      "duckdb_profile_modern.json")]
    assert [[dataclasses.asdict(a) for a in g] for g in got] == \
        [[dataclasses.asdict(a) for a in w] for w in want]
    assert tobs.step_times_us(got[1]) == jobs.step_times_us(want[1])


# -- TestStatementProvenance ----------------------------------------------------


@pytest.mark.parametrize("post_kw,sql_kw", [
    (dict(layout_mode="col", cache_mode="auto"),
     dict(include_conversion=True)),
    (dict(layout_mode="col", cache_mode="auto"), dict(step_create="TABLE")),
    (dict(precision_mode="int8"), dict(include_conversion=True)),
], ids=["col", "table", "int8"])
def test_statement_provenance_matches_jax(post_kw, sql_kw):
    """Every emitted segment of the port's SQL carries the reference's
    text and provenance tag; bind and append steps are named like the
    pipeline's steps, quantised tables are tagged."""
    jpipe, tpipe = _decode_pipes(**post_kw)
    got = t_sql_prov(tpipe, dialect="duckdb", **sql_kw)
    want = j_sql_prov(jpipe, dialect="duckdb", **sql_kw)
    assert [(s, dataclasses.asdict(p)) for s, p in got] == \
        [(s, dataclasses.asdict(p)) for s, p in want]
    tagged = {p.step for _, p in got if p.kind in ("bind", "append")}
    assert tagged == {s.name for s in tpipe.steps}
    if post_kw.get("precision_mode"):
        quant = [p for _, p in got if p.kind == "bind" and p.quantised]
        assert quant and all(t.endswith("__int8")
                             for p in quant for t in p.quantised)


# -- TestDbTraceSqlite ------------------------------------------------------------


class _Prov:
    def __init__(self, step, tables=(), ops=(), kind="bind"):
        self.kind, self.step, self.tables, self.ops = kind, step, tables, ops
        self.quantised = ()


def test_split_and_substitute_match_jax():
    script = ("-- planner annotation\nCREATE TABLE t (a INT);\n"
              "-- another\nINSERT INTO t VALUES (1);")
    assert tobs.split_statements(script) == jobs.split_statements(script) \
        == ["CREATE TABLE t (a INT);", "INSERT INTO t VALUES (1);"]
    sub = ("p = :pos AND q = :pos2", {"pos": 3, "pos2": 9})
    assert tobs.substitute_params(*sub) == jobs.substitute_params(*sub) \
        == "p = 3 AND q = 9"


def _timed_structure(tick):
    """What of a ``TickTrace`` does not depend on the clock."""
    return ([(s.sql, s.provenance.step, [
        (a.step, a.op_class, a.operator, a.table) for a in s.attributed])
        for s in tick.statements], sorted(tick.step_times_us()),
        sorted(tick.class_times_us()))


@pytest.mark.parametrize("obs", PACKAGES)
def test_run_timed_attributes_statement_wall_time(obs):
    tick = obs.run_timed(sqlite3.connect(":memory:"), [
        ("CREATE TABLE t (a INT);\nINSERT INTO t VALUES (1), (2);",
         _Prov("s1", ("t",), ("scan",))),
        ("SELECT COUNT(*) FROM t WHERE a > :lo;",
         _Prov("s1", ("t",), ("scan",))),
    ], params={"lo": 0})
    assert len(tick.statements) == 3
    assert tick.coverage() == pytest.approx(1.0)
    assert set(tick.step_times_us()) == {"s1"}
    assert tick.step_times_us()["s1"] > 0
    classes = tick.class_times_us()
    assert set(classes) == {"statement", "scan"}
    assert sum(classes.values()) == pytest.approx(tick.wall_s * 1e6)


def _join_db():
    con = sqlite3.connect(":memory:")
    con.execute("CREATE TABLE w (k INT PRIMARY KEY, v REAL)")
    con.execute("CREATE TABLE x (k INT, v REAL)")
    con.executemany("INSERT INTO w VALUES (?, ?)",
                    [(i, float(i)) for i in range(8)])
    con.executemany("INSERT INTO x VALUES (?, ?)",
                    [(i % 4, 1.0) for i in range(16)])
    return con


def test_run_timed_eqp_join_matches_jax():
    """SQLite's EXPLAIN QUERY PLAN rows split a join's wall time over the
    same operators, classes and tables in both packages."""
    stmt = ("SELECT w.k, SUM(w.v * x.v) FROM w JOIN x ON w.k = x.k "
            "GROUP BY w.k ORDER BY w.k;")
    prov = _Prov("join_step", ("w", "x"), ("join",))
    got = tobs.run_timed(_join_db(), [(stmt, prov)])
    want = jobs.run_timed(_join_db(), [(stmt, prov)])
    assert _timed_structure(got) == _timed_structure(want)
    classes = {a.op_class for a in got.attributed}
    assert "join" in classes and classes & {"scan", "search"}
    assert got.step_times_us()["join_step"] == pytest.approx(
        got.wall_s * 1e6)
    assert got.coverage() == pytest.approx(1.0)


@pytest.mark.parametrize("obs", PACKAGES)
def test_run_timed_explain_off_restores_fallback(obs):
    con = sqlite3.connect(":memory:")
    con.execute("CREATE TABLE t (a INT)")
    tick = obs.run_timed(con, [("SELECT * FROM t;", _Prov("s"))],
                         explain=False)
    assert [a.op_class for a in tick.attributed] == ["statement"]


def test_classify_eqp_detail_variants():
    assert classify_eqp_detail("SCAN t") == ("scan", "SCAN", "t")
    assert classify_eqp_detail("SCAN TABLE t") == ("scan", "SCAN", "t")
    assert classify_eqp_detail(
        "SEARCH w USING INTEGER PRIMARY KEY (rowid=?)",
        first_in_parent=False) == ("join", "SEARCH", "w")
    assert classify_eqp_detail("USE TEMP B-TREE FOR ORDER BY")[0] == "sort"
    assert classify_eqp_detail("")[0] == "other"


@pytest.mark.parametrize("obs", PACKAGES)
def test_tick_trace_exports(obs, tmp_path):
    tick = obs.run_timed(sqlite3.connect(":memory:"),
                         [("SELECT 1;", _Prov("s1"))])
    cats = {e["cat"] for e in tick.to_recorder().to_chrome()["traceEvents"]}
    assert "statement" in cats
    path = str(tmp_path / "tick.json")
    tick.save_json(path)
    with open(path) as f:
        dump = json.load(f)
    assert dump["coverage"] == pytest.approx(1.0)
    assert dump["statements"][0]["step"] == "s1"


def test_run_timed_over_the_ports_sql_matches_jax():
    """The DDL segments of the port's generated SQL (SQLite cannot run
    the views: no list functions) under ``run_timed``: the same
    statements, tags and operator attribution as the reference's SQL,
    and each table is created."""
    jpipe, tpipe = _decode_pipes(layout_mode="col", cache_mode="auto")

    def ddl(pairs):
        return [(sql, p) for sql, p in pairs if p.kind == "ddl"]
    ticks = []
    for obs, pairs in ((tobs, ddl(t_sql_prov(tpipe, dialect="ansi"))),
                       (jobs, ddl(j_sql_prov(jpipe, dialect="ansi")))):
        con = sqlite3.connect(":memory:")
        ticks.append((obs.run_timed(con, pairs), con))
    (got, con), (want, _) = ticks
    assert _timed_structure(got) == _timed_structure(want)
    made = {r[0] for r in con.execute(
        "SELECT name FROM sqlite_master WHERE type = 'table'")}
    targets = {s.provenance.target for s in got.statements
               if s.provenance.kind == "ddl"}
    assert targets and targets <= made
    # DDL serves no pipeline step: none of its time is attributed
    assert got.step_times_us() == {} and got.coverage() == 0.0


def test_traced_duckdb_decode_attributes_steps(tmp_path):
    """The reference's closed loop (``tests/test_duckdb_e2e.py``
    ``TestTracedDecodeEndToEnd``) on the port's SQL: a decode tick under
    DuckDB's profiler, its operators attributed to the port's pipeline
    steps (coverage >= 0.9), the logits the port's executor's, and a
    drift report from the same tick."""
    duckdb = pytest.importorskip("duckdb")
    _, pipe = _decode_pipes(layout_mode="col", cache_mode="auto")
    env = tlg.convert_weights(PARAMS, chunk_size=CS, device="cpu")
    env.update(tlg.empty_cache_tables(T_SPEC, 4, chunk_size=CS,
                                      device="cpu"))
    env["token_ids"] = tlg.token_table(np.asarray([5]), device="cpu")
    env["freq_each_token"] = tlg.rope_freq_table(
        np.asarray([0]), T_SPEC.head_dim, T_SPEC.rope_theta, device="cpu")
    outs, _ = t_run(pipe, env, scalars={"cache_position": 0})
    ref = outs["logits"].cols["v"].reshape(-1)[: T_SPEC.vocab].numpy()

    def listify(sql):
        return re.sub(r"(FLOAT|TINYINT|UTINYINT)\[\d+\]", r"\1[]", sql)
    pairs = [(tobs.substitute_params(listify(sql), {"cache_position": 0}),
              prov) for sql, prov in t_sql_prov(
                  pipe, dialect="duckdb", include_conversion=True,
                  step_create="TABLE")]
    setup = [p for p in pairs if p[1].kind in ("prelude", "comment", "ddl")]
    conv = [p for p in pairs if p[1].kind == "conversion"]
    tick_stmts = [p for p in pairs if p[1].kind in ("bind", "append")]
    con = duckdb.connect()
    tobs.run_statements(con, setup)

    def insert(name, arr):
        rows = [tuple(int(i) for i in idx) + (
            (arr[idx].tolist(),) if arr[idx].ndim else (float(arr[idx]),))
            for idx in np.ndindex(*arr.shape[:-1])]
        con.executemany(f"INSERT INTO {name} VALUES "
                        f"({', '.join('?' * len(rows[0]))})", rows)
    for name, arr in PARAMS.items():
        w = arr.shape[-1]
        insert(name, arr.reshape(*arr.shape[:-1], w // CS, CS)
               if w >= CS else arr.reshape(*arr.shape[:-1], 1, w))
    for name in ("token_ids", "freq_each_token"):
        t = env[name]
        arrs = [c.numpy() for c in t.cols.values()]
        rows = [tuple(int(i) for i in idx) + tuple(
            a[idx].tolist() if a[idx].ndim else float(a[idx])
            for a in arrs) for idx in np.ndindex(*t.key_sizes)]
        con.executemany(f"INSERT INTO {name} VALUES "
                        f"({', '.join('?' * len(rows[0]))})", rows)
    tobs.run_statements(con, conv)
    tick = tobs.run_traced(con, tick_stmts)
    got = np.concatenate([np.asarray(v, np.float32) for _, v in con.execute(
        "SELECT c, v FROM logits ORDER BY c").fetchall()])[: T_SPEC.vocab]
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)
    times = tick.step_times_us()
    assert set(times) == {s.name for s in pipe.steps}
    assert tick.coverage() >= 0.9
    feats = t_features(T_SPEC, "decode", 1, CS, "col", cache_len=4)
    rep = tobs.drift_report(feats, times)
    assert {s.step for s in rep.steps} == set(feats) and rep.scale_us > 0


# -- TestDriftReport --------------------------------------------------------------


DRIFT_CASES = {
    "on_model": ({"a": (100.0, 10.0), "b": (200.0, 40.0), "c": (50.0, 5.0)},
                 {"a": 227.0, "b": 487.0, "c": 117.0}, {}),
    "off_model": ({"a": (100.0, 0.0), "b": (100.0, 0.0), "c": (100.0, 0.0),
                   "slow": (100.0, 0.0)},
                  {"a": 100.0, "b": 100.0, "c": 100.0, "slow": 400.0}, {}),
    "unattributed": ({"a": (10.0, 0.0)}, {"a": 10.0, "mystery": 90.0}, {}),
    "fixed_scale": ({"a": (100.0, 0.0), "b": (300.0, 0.0)},
                    {"a": 300.0, "b": 900.0}, {"scale_us": 1.5}),
    "empty": ({}, {"x": 5.0}, {}),
    "disjoint": ({"a": (10.0, 1.0)}, {"b": 7.0, "c": 3.0}, {}),
    "zero_units": ({"z": (0.0, 0.0)}, {"z": 4.0}, {}),
    "zero_observed": ({"a": (10.0, 0.0), "b": (20.0, 0.0)},
                      {"a": 0.0, "b": 0.0}, {}),
    "group_weight": ({"a": (100.0, 10.0), "b": (200.0, 40.0)},
                     {"a": 300.0, "b": 500.0}, {"group_weight": 2.5}),
}


@pytest.mark.parametrize("case", sorted(DRIFT_CASES))
def test_drift_report_matches_jax(case):
    """The reference's drift cases (and a non-default group weight) give
    the same report, worst steps and JSON in both packages."""
    feats, obs, kw = DRIFT_CASES[case]
    got, want = tobs.drift_report(feats, obs, **kw), jobs.drift_report(
        feats, obs, **kw)
    assert json.dumps(got.to_dict(), sort_keys=True) == json.dumps(
        want.to_dict(), sort_keys=True)
    assert [s.step for s in got.worst(2)] == [s.step for s in want.worst(2)]
    if case == "on_model":
        assert got.scale_us == pytest.approx(2.0)
        assert got.intercept_us == pytest.approx(7.0)
        assert got.rms_rel_drift == pytest.approx(0.0, abs=1e-9)
    elif case == "off_model":
        assert got.worst(1)[0].step == "slow" and got.rms_rel_drift > 0.3
    elif case == "unattributed":
        assert got.unattributed_us == pytest.approx(90.0)
    elif case == "zero_units":
        assert got.steps[0].ratio == float("inf")


@pytest.mark.parametrize("weight", [1.0, 2.5])
def test_fit_from_step_timings_matches_jax(weight):
    """Step features of the port's planner and the reference's are equal;
    one set of synthetic step times fits to the same weights, and the
    drift report of the fitted weights is the same."""
    feats = t_features(T_SPEC, "decode", 1, CS, "col", cache_len=4)
    assert feats == j_features(J_SPEC, "decode", 1, CS, "col", cache_len=4)
    obs = {s: 3.0 * (r + weight * g) + 11.0 for s, (r, g) in feats.items()}
    got, want = t_fit(feats, obs), j_fit(feats, obs)
    assert dataclasses.asdict(got.params) == dataclasses.asdict(want.params)
    assert (got.scale_us, got.intercept_us, got.n_points) == (
        want.scale_us, want.intercept_us, want.n_points)
    assert got.params.group_weight == pytest.approx(weight, rel=1e-6)
    assert tobs.drift_report(
        feats, obs, group_weight=got.params.group_weight).to_dict() == \
        jobs.drift_report(feats, obs,
                          group_weight=want.params.group_weight).to_dict()


# -- TestTracedRunPipeline ---------------------------------------------------------


def _pipeline_envs():
    jenv = jlg.convert_weights(PARAMS, chunk_size=CS)
    jenv.update(jlg.empty_cache_tables(J_SPEC, 4, chunk_size=CS))
    jenv["token_ids"] = jlg.token_table(np.asarray([5], np.int32))
    jenv["freq_each_token"] = jlg.rope_freq_table(
        np.asarray([0]), J_SPEC.head_dim, J_SPEC.rope_theta)
    tenv = tlg.convert_weights(PARAMS, chunk_size=CS, device="cpu")
    tenv.update(tlg.empty_cache_tables(T_SPEC, 4, chunk_size=CS,
                                       device="cpu"))
    tenv["token_ids"] = tlg.token_table(np.asarray([5]), device="cpu")
    tenv["freq_each_token"] = tlg.rope_freq_table(
        np.asarray([0]), T_SPEC.head_dim, T_SPEC.rope_theta, device="cpu")
    return jenv, tenv


@pytest.mark.parametrize("post_kw", [
    dict(layout_mode="col", cache_mode="auto"),
    dict(layout_mode="off", cache_mode="off"),
    dict(layout_mode="auto", cache_mode="pos_major"),
], ids=["col", "unplanned", "pos_major"])
def test_traced_run_pipeline_matches_jax(post_kw):
    """One ``cat="step"`` span a step with the reference's name, order,
    ``kind``, ``ops`` and ``tables``, and the executor's ``cat="op"``
    spans nested under them: the same spans as the JAX executor's, the
    op spans too (the attention subplan's inner nodes are steps of their
    own, which both run, so K2/K3's fused GroupAgg skips no node the
    reference visits).  Tracing leaves the logits as they are."""
    jpipe, tpipe = _decode_pipes(**post_kw)
    jenv, tenv = _pipeline_envs()
    jt, tt = jobs.TraceRecorder(), tobs.TraceRecorder()
    jout, _ = j_run(jpipe, jenv, scalars={"cache_position": 0}, tracer=jt)
    tout, _ = t_run(tpipe, tenv, scalars={"cache_position": 0}, tracer=tt)
    ref, _ = t_run(tpipe, tenv, scalars={"cache_position": 0})
    assert torch.equal(tout["logits"].cols["v"], ref["logits"].cols["v"])
    np.testing.assert_allclose(tout["logits"].cols["v"].numpy(),
                               np.asarray(jout["logits"].cols["v"]),
                               rtol=1e-5, atol=1e-5)
    steps = [e for e in tt.events if e.cat == "step"]
    assert [e.name for e in steps] == [s.name for s in tpipe.steps]
    assert all(e.depth == 0 for e in steps)
    assert [span_key(e) for e in steps] == [
        span_key(e) for e in jt.events if e.cat == "step"]
    ops = [e for e in tt.events if e.cat == "op"]
    assert ops and all(e.depth >= 1 for e in ops)
    assert [span_key(e) for e in tt.events] == [
        span_key(e) for e in jt.events]


def test_steps_provenance_is_plan_provenance():
    """The one-pass provenance the step spans carry equals walking each
    step's plan anew (the reference's ``plan_provenance``), batched and
    at depth."""
    spec = tlg.LlamaSpec(**dict(WIDE_ARGS, n_layers=4))
    g = tlg.build_decode_graph(spec, cache_len=8, batch=2)
    t_infer(g)
    t_pre(g)
    pipe = t_op_map(g, chunk_size=8)
    t_post(pipe, layout_mode="auto", cache_mode="auto")
    roots = [s.rel.plan for s in pipe.steps]
    assert steps_provenance(roots) == [plan_provenance(r) for r in roots]


# -- traced engines ----------------------------------------------------------------


def _traced_engines(**knobs):
    jt, tt = jobs.TraceRecorder(), tobs.TraceRecorder()
    je = JEngine(jlg.LlamaSpec(**WIDE_ARGS), WIDE_PARAMS, chunk_size=8,
                 max_len=32, tracer=jt, **knobs)
    te = RelationalEngine(tlg.LlamaSpec(**WIDE_ARGS), WIDE_PARAMS,
                          chunk_size=8, max_len=32, tracer=tt,
                          device="cpu", **knobs)
    return (je, jt), (te, tt)


@pytest.mark.parametrize("knobs", [
    {}, dict(row2col="off", cache_layout="off"),
    dict(row2col="col", cache_layout="pos_major")],
    ids=["planned", "unplanned", "col_pos_major"])
def test_traced_engine_matches_jax(knobs):
    """The engine with a tracer (the knob that raised before this slice):
    its plan-compile, session, decoder-phase, step and op spans equal the
    JAX engine's one for one, through cold and prefix-hit prefills
    (``prefix_lookup``, ``cache_fill`` with ``prefix_hit``) and batched
    decode ticks (``cache_views``, ``cache_writeback``,
    ``logits_argmax``), and the tokens are the JAX engine's."""
    (je, jt), (te, tt) = _traced_engines(**knobs)
    shared = [1, 2, 3, 4, 5, 6, 7, 8]
    toks = []
    for eng in (je, te):
        dec = eng.batched_decoder(4, prefix_block=4)
        last = [dec.prefill_ex(shared + tail, s)[0]
                for s, tail in enumerate(([9, 10], [11], [12, 13, 14]))]
        for _ in range(3):
            last = dec.decode([0, 1, 2], last)
        toks.append(last)
    assert toks[0] == toks[1]
    assert [span_key(e) for e in jax_twins(tt)] == [
        span_key(e) for e in jt.events]
    names = {e.name for e in tt.events if e.cat in ("decoder", "plan")}
    assert {"session_env", "prefix_lookup", "cache_fill", "cache_views",
            "cache_writeback", "logits_argmax",
            "compile:llama_decode_b4"} <= names
    assert any(e.args.get("prefix_hit") == 8 for e in tt.events
               if e.name == "cache_fill")


def test_traced_engine_keeps_tokens_and_metrics():
    """The reference's ``TestServingMetricsSmoke::
    test_engine_records_metrics_and_traces`` on the port: a traced engine
    with a registry generates the untraced engine's tokens, records every
    prefill and decode step span, and the disabled engine has neither."""
    reg, tracer = tobs.MetricsRegistry(), tobs.TraceRecorder()
    eng = RelationalEngine(T_SPEC, PARAMS, chunk_size=CS, max_len=8,
                           metrics=reg, tracer=tracer, device="cpu")
    plain = RelationalEngine(T_SPEC, PARAMS, chunk_size=CS, max_len=8,
                             device="cpu")
    assert eng.generate([3, 5], 3).tokens == plain.generate([3, 5],
                                                            3).tokens
    dump = reg.to_dict()
    assert dump["engine_decode_step_seconds"][0]["count"] == 2
    steps = [e.name for e in tracer.events if e.cat == "step"]
    assert steps == [s.name for s in eng._prefill_pipe(2).steps] + 2 * [
        s.name for s in eng.decode_pipe.steps]
    assert plain.metrics is None and plain.tracer is None


@pytest.mark.parametrize("budget", [40_000, None], ids=["paged", "memory"])
def test_traced_paged_engine_matches_jax(tmp_path, budget):
    """A traced paged engine: the step and op spans of a session equal
    the JAX engine's, and the tokens are equal.  The pager's spans are the
    port's own: its "pin" schedule (fixed by the first pass over the
    budget) issues the streamed tables' copies ahead of their Scans, where
    the reference misses on each, so the port records one
    ``pager_fetch:`` span a miss and one ``pager_prefetch:`` span a copy
    issued ahead (the ``vocabulary`` table, which each session prefetches
    on a thread before the schedule is fixed, is fetched or prefetched by
    whichever gets there first, so its spans are left out)."""
    knobs = (dict(residency="paged", budget_bytes=budget)
             if budget else {})
    (je, jt), (te, tt) = _traced_engines(**knobs)
    jt.clear()
    tt.clear()
    misses = te.pager.stats.misses if budget else 0
    toks = [eng.generate([3, 17, 42, 5], 4).tokens for eng in (je, te)]
    assert toks[0] == toks[1]

    def keys(tracer):
        return [span_key(e) for e in tracer.events
                if e.cat != "pager" and e.name != "device_wait"]
    assert keys(tt) == keys(jt)
    fetches = [e for e in tt.events if e.name.startswith("pager_fetch:")]
    assert bool(fetches) == bool(budget)
    if budget:
        assert len(fetches) == te.pager.stats.misses - misses
        ahead = [e for e in tt.events if e.name.startswith("pager_prefetch:")
                 and not e.name.endswith(":vocabulary")]
        assert te.pager.schedule is not None and ahead
        assert all(e.cat == "pager" and e.depth == 1 for e in ahead)
