"""The port's training path (``repro_torch.{data,training}`` and the model
stack's backward) against the JAX package's, on the CPU.

The same numpy-seeded inputs go through both packages; the reference's
parameter trees cross into the port with ``tree_from_numpy``.  Tolerances
(f32 unless stated):

- data batches byte-equal;
- the schedule within 1e-6 (relative);
- AdamW's params and moments within 1e-6 in f32, and within one bf16 ulp
  (2^-7 relative) where a leaf or the state is bfloat16;
- ``global_norm`` within 1e-6 (relative), clipped grads as AdamW's;
- cross entropy within 1e-6, its gradient within 1e-7;
- every family's loss within 1e-5 and each gradient leaf within 5e-5 of
  that leaf's largest |gradient|, with ``remat`` "none" and "full";
- a train step's loss, ``grad_norm`` and ``lr`` within 1e-5, its params
  within 1e-5 except at most 0.1 % of elements, which may differ by up to
  2·lr (a near-zero gradient whose sign flips moves Adam's first step by
  ±lr — the flips the reference's own test allows for);
- checkpoints byte-equal across the packages; the recovery driver's
  losses within 1e-4 of the reference's, and its restart within 1e-6 of
  its uninterrupted run (the reference's bar).

The reference's ``tests/test_training.py`` cases run on the port as well.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import fault_tolerance as jft  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_loop as jtl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.registry import ASSIGNED  # noqa: E402
from repro_torch.data.pipeline import (SyntheticLM,  # noqa: E402
                                       TokenFileSource)
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training.fault_tolerance import (  # noqa: E402
    FaultConfig, run_with_recovery)
from repro_torch.training.optimizer import (AdamW, AdamWState,  # noqa: E402
                                            clip_by_global_norm,
                                            global_norm)
from repro_torch.training.train_loop import (  # noqa: E402
    cross_entropy_loss, loss_fn, make_train_step)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ASSIGNED + ["llama3-8b"]
CPU = "cpu"
J_INIT = jax.jit(jtf.init_params, static_argnums=0)
J_GRAD = jax.jit(jax.value_and_grad(jtl.loss_fn, has_aux=True),
                 static_argnums=2)
BF16_ULP = 2.0 ** -7


def _np(t):
    """A port tensor as numpy f32 (bfloat16 included)."""
    return t.detach().float().numpy()


def _jnp(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _jax_params(cfg):
    return jax.tree_util.tree_map(np.asarray,
                                  J_INIT(cfg, jax.random.PRNGKey(0)))


def _paths(tree):
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _batch(cfg, seq=16, batch=2, step=0):
    b = SyntheticLM(vocab=cfg.vocab, seq_len=seq,
                    global_batch=batch).batch_at(step)
    rng = np.random.default_rng(step)
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal(
            (batch, cfg.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["images"] = rng.standard_normal(
            (batch, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _assert_step_params(got, want, lr, tol=1e-5):
    """One AdamW step's params: within ``tol`` except for sign flips of
    near-zero gradients (at most 0.1 % of a leaf, each within 2·lr)."""
    diff = np.abs(got - want)
    flips = diff > tol
    assert flips.mean() <= 1e-3, (flips.sum(), diff.max())
    assert diff.max() <= 2 * lr * (1 + 1e-4) + tol, diff.max()


# -- data ---------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(vocab=512, seq_len=16, global_batch=4),
    dict(vocab=128256, seq_len=256, global_batch=4, seed=3),
    dict(vocab=1024, seq_len=33, global_batch=8, n_shards=2, shard=1),
], ids=["small", "llama3-vocab", "sharded"])
def test_synthetic_batches_are_byte_equal(kw):
    for step in (0, 1, 7, 123):
        want = jdata.SyntheticLM(**kw).batch_at(step)
        got = SyntheticLM(**kw).batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            assert got[k].tobytes() == want[k].tobytes(), (k, step)
    it = iter(SyntheticLM(**kw))
    assert next(it)["tokens"].tobytes() == SyntheticLM(**kw).batch_at(
        0)["tokens"].tobytes()


def test_token_file_batches_are_byte_equal(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 5000, 4096).astype(
        np.int32).tofile(path)
    for shard in (0, 1):
        kw = dict(path=str(path), vocab=1000, seq_len=31, global_batch=4,
                  n_shards=2, shard=shard)
        for step in range(6):
            want = jdata.TokenFileSource(**kw).batch_at(step)
            got = TokenFileSource(**kw).batch_at(step)
            for k in want:
                assert got[k].tobytes() == want[k].tobytes(), (k, step)


# -- optimizer ----------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(), dict(lr=3e-3, warmup_steps=2, total_steps=60),
    dict(lr=0.1, warmup_steps=0, total_steps=200, min_lr_ratio=1.0)],
    ids=["default", "short", "flat"])
def test_schedule_matches_jax(kw):
    j, t = jopt.AdamW(**kw), AdamW(**kw)
    steps = np.arange(0, t.total_steps + 10, max(1, t.total_steps // 97))
    for s in steps:
        want = float(j.schedule(jnp.asarray(s, jnp.int32)))
        got = t.schedule(torch.tensor(int(s), dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12), s


def _opt_tree(rng, dtype):
    """A matrix and a stacked [L, d] leaf (decayed), a vector and a 0-d
    leaf (not decayed), nested as a param tree."""
    return {"w": rng.standard_normal((16, 24)).astype(dtype),
            "g0": {"scale": (1 + 0.1 * rng.standard_normal((3, 24))
                             ).astype(dtype),
                   "bias": rng.standard_normal(24).astype(dtype)},
            "gate": np.asarray(rng.standard_normal(), dtype)}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(param_dtype, state_dtype):
    import ml_dtypes
    npdt = np.float32 if param_dtype == "float32" else ml_dtypes.bfloat16
    rng = np.random.default_rng(0)
    params = _opt_tree(rng, npdt)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
              state_dtype=state_dtype)
    j, t = jopt.AdamW(**kw), AdamW(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = j.init(jp)
    tp = tf.tree_from_numpy(params, CPU)
    ts = t.init(tp)
    assert ts.step.dtype == torch.int32 and ts.step.shape == ()
    for _ in range(3):
        grads = _opt_tree(rng, npdt)
        jp, js = j.update(jax.tree_util.tree_map(jnp.asarray, grads), js, jp)
        tp2, ts = t.update(tf.tree_from_numpy(grads, CPU), ts, tp)
        assert tp2 is tp  # written in place
    assert int(ts.step) == int(js.step) == 3
    for name, want, got in (("params", jp, tp), ("m", js.m, ts.m),
                            ("v", js.v, ts.v)):
        dt = param_dtype if name == "params" else state_dtype
        rtol = 1e-6 if dt == "float32" else BF16_ULP
        for (path, w), g in zip(
                jax.tree_util.tree_flatten_with_path(want)[0],
                tf.tree_leaves(got)):
            assert str(g.dtype).endswith(dt), (name, path, g.dtype)
            np.testing.assert_allclose(_np(g), _jnp(w), rtol=rtol,
                                       atol=1e-7, err_msg=f"{name} {path}")


def test_global_norm_and_clip_match_jax():
    import ml_dtypes
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((40, 30)).astype(np.float32),
            "b": {"c": rng.standard_normal(50).astype(ml_dtypes.bfloat16),
                  "d": np.asarray(3.0, np.float32)}}
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    want = float(jopt.global_norm(jt))
    assert float(global_norm(tf.tree_from_numpy(tree, CPU))) == \
        pytest.approx(want, rel=1e-6)
    for max_norm in (1.0, 2 * want):
        jc, jn = jopt.clip_by_global_norm(jt, max_norm)
        tt = tf.tree_from_numpy(tree, CPU)
        tc, tn = clip_by_global_norm(tt, max_norm)
        assert tc is tt and float(tn) == pytest.approx(float(jn), rel=1e-6)
        for w, g in zip(jax.tree_util.tree_leaves(jc), tf.tree_leaves(tc)):
            rtol = BF16_ULP if g.dtype == torch.bfloat16 else 1e-6
            np.testing.assert_allclose(_np(g), _jnp(w), rtol=rtol,
                                       atol=1e-7)
            assert str(g.dtype).endswith(str(w.dtype))


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("impl", ["gather", "onehot"])
def test_cross_entropy_matches_jax(impl, masked):
    rng = np.random.default_rng(2)
    logits = (3 * rng.standard_normal((2, 7, 33))).astype(np.float32)
    labels = rng.integers(0, 33, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) > 0.3).astype(np.float32) if masked else None

    def jloss(lg):
        return jtl.cross_entropy_loss(
            lg, jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask), impl=impl)
    want, jgrad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_(True)
    got = cross_entropy_loss(lg, torch.from_numpy(labels),
                             None if mask is None else torch.from_numpy(mask),
                             impl=impl)
    assert got.dtype == torch.float32
    (grad,) = torch.autograd.grad(got, lg)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), atol=1e-7)


def test_cross_entropy_upcasts_bf16_logits():
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((3, 5, 17)).astype(
        np.float32)).to(torch.bfloat16)
    labels = torch.from_numpy(rng.integers(0, 17, (3, 5)).astype(np.int32))
    got = cross_entropy_loss(logits, labels)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(
        float(cross_entropy_loss(logits.float(), labels)), abs=0)


# -- the model stack's backward -----------------------------------------------


@pytest.fixture(scope="module")
def weights():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _jax_params(j_get_config(arch, tiny=True))
        return cache[arch]
    return get


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(weights, arch, remat):
    jcfg = dataclasses.replace(j_get_config(arch, tiny=True), remat=remat)
    tcfg = dataclasses.replace(get_config(arch, tiny=True), remat=remat)
    jp = weights(arch)
    jb, tb = _batch(tcfg)
    (jl, _), jg = J_GRAD(jp, jb, jcfg)
    live = [p.requires_grad_(True) for p in tf.tree_leaves(
        tf.tree_from_numpy(jp, CPU))]
    loss, metrics = loss_fn(tf.tree_unflatten(jp, live), tb, tcfg)
    assert metrics["loss"] is loss and loss.dtype == torch.float32
    grads = torch.autograd.grad(loss, live, allow_unused=True,
                                materialize_grads=True)
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5
    jpaths, jleaves = _paths(jg), jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(grads)
    for path, w, g in zip(jpaths, jleaves, grads):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == live[0].dtype, path
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g.numpy() - w).max()) <= 5e-5 * scale, path


def _count_layer_calls(monkeypatch):
    calls = {"n": 0}
    block_apply = tf.block_apply

    def counted(*a, **k):
        calls["n"] += 1
        return block_apply(*a, **k)
    monkeypatch.setattr(tf, "block_apply", counted)
    return calls


@pytest.mark.parametrize("arch", ["llama3-8b", "olmoe-1b-7b", "mamba2-2.7b",
                                  "hymba-1.5b"])
def test_remat_recomputes_each_layer(monkeypatch, arch):
    """``remat="full"`` runs every layer again in the backward (twice the
    block calls of a forward and backward without it) and gives the same
    loss and gradients bit for bit; without a gradient it runs each layer
    once."""
    calls = _count_layer_calls(monkeypatch)
    base = get_config(arch, tiny=True)
    params = tf.init_params(base, 0, device=CPU)
    _, tb = _batch(base)
    out = {}
    for remat in ("none", "full"):
        cfg = dataclasses.replace(base, remat=remat)
        live = [p.detach().requires_grad_(True)
                for p in tf.tree_leaves(params)]
        calls["n"] = 0
        loss, _ = loss_fn(tf.tree_unflatten(params, live), tb, cfg)
        grads = torch.autograd.grad(loss, live, allow_unused=True,
                                    materialize_grads=True)
        out[remat] = (calls["n"], loss, grads)
        calls["n"] = 0
        with torch.no_grad():
            loss_fn(params, tb, cfg)
        assert calls["n"] == base.n_layers
    assert out["none"][0] == base.n_layers
    assert out["full"][0] == 2 * base.n_layers
    assert torch.equal(out["none"][1], out["full"][1])
    for a, b in zip(out["none"][2], out["full"][2]):
        assert torch.equal(a, b)


def _accumulate_grad_consumers(loss):
    """For each parameter leaf of the backward graph, the names of the
    graph nodes that feed its gradient."""
    seen, stack, feeds = set(), [loss.grad_fn], {}
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if nxt is not None and type(nxt).__name__ == "AccumulateGrad":
                feeds.setdefault(id(nxt.variable), []).append(node.name())
            stack.append(nxt)
    return feeds


@pytest.mark.parametrize("remat", ["none", "full"])
def test_stacked_params_are_indexed_once_per_group(remat):
    """Each stacked leaf reaches the graph through one ``unbind`` (its
    backward one ``stack``), not one ``select`` a layer."""
    cfg = dataclasses.replace(get_config("llama3-8b", tiny=True),
                              remat=remat)
    params = tf.init_params(cfg, 0, device=CPU)
    live = tf.tree_unflatten(params, [p.requires_grad_(True) for p in
                                      tf.tree_leaves(params)])
    _, tb = _batch(cfg)
    loss, _ = loss_fn(live, tb, cfg)
    feeds = _accumulate_grad_consumers(loss)
    stacked = list(tf.tree_leaves(live["g0"]))
    for leaf in stacked:
        assert feeds[id(leaf)] == ["UnbindBackward0"], feeds[id(leaf)]


# -- the train step -----------------------------------------------------------


def _step_pair(grad_accum, cfg_name="llama3-8b", lr=3e-3):
    jcfg, tcfg = j_get_config(cfg_name, tiny=True), get_config(cfg_name,
                                                              tiny=True)
    kw = dict(lr=lr, warmup_steps=2, total_steps=60)
    jstep = jax.jit(jtl.make_train_step(jcfg, jopt.AdamW(**kw),
                                        grad_accum=grad_accum))
    tstep = make_train_step(tcfg, AdamW(**kw), grad_accum=grad_accum)
    return jcfg, tcfg, jstep, tstep, jopt.AdamW(**kw), AdamW(**kw)


@pytest.mark.parametrize("grad_accum", [1, 4])
def test_train_step_matches_jax(weights, grad_accum):
    lr = 3e-3
    jcfg, tcfg, jstep, tstep, jo, to = _step_pair(grad_accum, lr=lr)
    jp = weights("llama3-8b")
    tp = tf.tree_from_numpy(jp, CPU)
    jstate, tstate = jo.init(jax.tree_util.tree_map(jnp.asarray, jp)), \
        to.init(tp)
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    for i in range(2):
        jb, tb = _batch(tcfg, seq=16, batch=8, step=i)
        jparams, jstate, jm = jstep(jparams, jstate, jb)
        tp2, tstate, tm = tstep(tp, tstate, tb)
        assert tp2 is tp
        assert sorted(tm) == sorted(jm) == ["grad_norm", "loss", "lr"]
        for k in jm:
            assert tm[k].shape == () and tm[k].dtype == torch.float32
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                                 abs=1e-7), (k, i)
        for w, g in zip(jax.tree_util.tree_leaves(jparams),
                        tf.tree_leaves(tp)):
            _assert_step_params(_np(g), _jnp(w), lr)
    assert int(tstate.step) == 2


def test_grad_accum_gives_f32_grads_to_the_clip(monkeypatch):
    """With accumulation the clip sees f32 gradients (the accumulators),
    with none it sees the parameters' dtype, as in the reference."""
    from repro_torch.training import train_loop
    seen = []
    clip = train_loop.clip_by_global_norm

    def spy(grads, max_norm):
        seen.append({g.dtype for g in tf.tree_leaves(grads)})
        return clip(grads, max_norm)
    monkeypatch.setattr(train_loop, "clip_by_global_norm", spy)
    cfg = dataclasses.replace(get_config("llama3-8b", tiny=True),
                              dtype="bfloat16", param_dtype="bfloat16")
    opt = AdamW()
    _, tb = _batch(cfg, seq=8, batch=4)
    for ga in (1, 2):
        p = tf.init_params(cfg, 0, device=CPU)
        make_train_step(cfg, opt, grad_accum=ga)(p, opt.init(p), tb)
    assert seen == [{torch.bfloat16}, {torch.float32}]


# -- the reference's tests/test_training.py, on the port ----------------------


class TestOptimizer:
    def test_adamw_converges_on_quadratic(self):
        opt = AdamW(lr=0.1, weight_decay=0.0, warmup_steps=0,
                    total_steps=200, min_lr_ratio=1.0)
        params = {"w": torch.tensor([[3.0, -2.0]])}
        state = opt.init(params)
        for _ in range(150):
            grads = {"w": 2 * params["w"]}
            params, state = opt.update(grads, state, params)
        assert float(params["w"].abs().max()) < 1e-2

    def test_bf16_state_halves_memory(self):
        params = {"w": torch.zeros((128, 128), dtype=torch.float32)}
        s32 = AdamW(state_dtype="float32").init(params)
        s16 = AdamW(state_dtype="bfloat16").init(params)
        assert s16.m["w"].dtype == torch.bfloat16

        def nbytes(t):
            return t.numel() * t.element_size()
        assert nbytes(s16.m["w"]) * 2 == nbytes(s32.m["w"])

    def test_clip_by_global_norm(self):
        g = {"a": torch.full((10,), 100.0)}
        clipped, norm = clip_by_global_norm(g, 1.0)
        assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-4)


class TestTrainLoop:
    def _setup(self, grad_accum=1):
        cfg = get_config("llama3-8b", tiny=True)
        params = tf.init_params(cfg, 0, device=CPU)
        opt = AdamW(lr=3e-3, warmup_steps=2, total_steps=60)
        step = make_train_step(cfg, opt, grad_accum=grad_accum)
        return cfg, params, opt, step

    def test_loss_decreases(self):
        cfg, params, opt, step = self._setup()
        state = opt.init(params)
        data = SyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=8)
        losses = []
        for i in range(30):
            b = {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}
            params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))
        assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3

    def test_grad_accum_equivalence(self):
        """k microbatches of size b == one batch of size k·b (same grads);
        the reference's tolerances.  The update is in place, so each step
        gets its own copy of the params and state."""
        cfg, params, opt, _ = self._setup()
        step1 = make_train_step(cfg, opt, grad_accum=1)
        step4 = make_train_step(cfg, opt, grad_accum=4)
        data = SyntheticLM(vocab=cfg.vocab, seq_len=16, global_batch=8)
        b = {k: torch.from_numpy(v) for k, v in data.batch_at(0).items()}
        p1, _, m1 = step1(tf.tree_map(torch.clone, params),
                          opt.init(params), b)
        p4, _, m4 = step4(tf.tree_map(torch.clone, params),
                          opt.init(params), b)
        d = [float((a - c).abs().max())
             for a, c in zip(tf.tree_leaves(p1), tf.tree_leaves(p4))]
        assert max(d) < 2e-3
        assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-3


class TestCheckpoint:
    def test_save_restore_exact(self, tmp_path):
        tree = {"a": torch.arange(6.0).reshape(2, 3),
                "b": {"c": torch.ones((4,), dtype=torch.bfloat16)}}
        ckpt.save(str(tmp_path), 7, tree, extra={"data_cursor": 7})
        abstract = tf.tree_map(lambda l: torch.empty_like(l, device="meta"),
                               tree)
        got, manifest = ckpt.restore(str(tmp_path), None, abstract,
                                     device=CPU)
        assert manifest["step"] == 7
        assert manifest["extra"]["data_cursor"] == 7
        for a, b in zip(tf.tree_leaves(tree), tf.tree_leaves(got)):
            assert a.dtype == b.dtype and torch.equal(a, b)

    def test_atomic_rename_no_tmp_left(self, tmp_path):
        ckpt.save(str(tmp_path), 1, {"x": torch.zeros(3)})
        assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))

    def test_garbage_collect_keeps_latest(self, tmp_path):
        for s in (1, 2, 3, 4, 5):
            ckpt.save(str(tmp_path), s, {"x": torch.zeros(2)})
        ckpt.garbage_collect(str(tmp_path), keep=2)
        assert ckpt.latest_step(str(tmp_path)) == 5
        assert len(os.listdir(tmp_path)) == 2

    def test_async_checkpointer(self, tmp_path):
        acp = ckpt.AsyncCheckpointer(str(tmp_path))
        acp.save(3, {"x": torch.full((8,), 3.0)})
        acp.wait()
        assert ckpt.latest_step(str(tmp_path)) == 3


class TestFaultTolerance:
    def _driver_parts(self):
        cfg = get_config("llama3-8b", tiny=True)
        opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=40)
        step = make_train_step(cfg, opt)
        data = SyntheticLM(vocab=cfg.vocab, seq_len=16, global_batch=4)

        def init_state():
            p = tf.init_params(cfg, 0, device=CPU)
            return p, opt.init(p)

        def batch_at(i):
            return {k: torch.from_numpy(v)
                    for k, v in data.batch_at(i).items()}

        return step, init_state, batch_at

    def test_restart_reproduces_uninterrupted_run(self, tmp_path):
        step, init_state, batch_at = self._driver_parts()
        ref = run_with_recovery(
            step, init_state, batch_at, total_steps=12,
            fault_cfg=FaultConfig(ckpt_dir=str(tmp_path / "ref"),
                                  ckpt_every=4))
        rec = run_with_recovery(
            step, init_state, batch_at, total_steps=12,
            fault_cfg=FaultConfig(ckpt_dir=str(tmp_path / "ft"),
                                  ckpt_every=4),
            fail_at={9: 0})
        assert rec.restarts == 1
        assert ref.steps_run == rec.steps_run == 12
        assert rec.losses[-1] == pytest.approx(ref.losses[-1], abs=1e-6)

    def test_multiple_failures(self, tmp_path):
        step, init_state, batch_at = self._driver_parts()
        rec = run_with_recovery(
            step, init_state, batch_at, total_steps=10,
            fault_cfg=FaultConfig(ckpt_dir=str(tmp_path / "ft2"),
                                  ckpt_every=2, max_restarts=5),
            fail_at={3: 0, 7: 1})
        assert rec.restarts == 2
        assert rec.steps_run == 10


# -- checkpoints across the packages ------------------------------------------


def _state_pair(seed=4):
    """The same (params, AdamWState) in both packages, with bf16 params and
    f32 moments, after one update so the moments are not zero."""
    import ml_dtypes
    rng = np.random.default_rng(seed)
    params = {"embed": {"embedding": rng.standard_normal((12, 8)).astype(
                  ml_dtypes.bfloat16)},
              "g0": {"ln1": {"scale": np.ones((2, 8), ml_dtypes.bfloat16)},
                     "w1": rng.standard_normal((2, 8, 16)).astype(
                         ml_dtypes.bfloat16)},
              "final_norm": {"scale": np.ones(8, np.float32)}}
    grads = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype), params)
    jo, to = jopt.AdamW(), AdamW()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jtree = jo.update(jax.tree_util.tree_map(jnp.asarray, grads),
                      jo.init(jp), jp)
    tp = tf.tree_from_numpy(params, CPU)
    ttree = to.update(tf.tree_from_numpy(grads, CPU), to.init(tp), tp)
    return jtree, ttree


def _files(path):
    return sorted(os.listdir(path))


def test_checkpoint_format_matches_jax(tmp_path):
    """Both packages write the same files, the same manifest (key order
    too) and the same bytes for the same state."""
    jtree, ttree = _state_pair()
    jpath = jckpt.save(str(tmp_path / "jax"), 5, jtree,
                       extra={"data_cursor": 5})
    tpath = ckpt.save(str(tmp_path / "port"), 5, ttree,
                      extra={"data_cursor": 5})
    assert os.path.basename(jpath) == os.path.basename(tpath) == \
        "step_00000005"
    assert _files(jpath) == _files(tpath)
    assert "1__.step.npy" in _files(tpath) and \
        "0__g0__w1.npy" in _files(tpath)
    with open(os.path.join(jpath, "manifest.json")) as f:
        jm = f.read()
    with open(os.path.join(tpath, "manifest.json")) as f:
        tm = f.read()
    assert tm == jm
    assert list(json.loads(tm)["leaves"]) == _paths(jtree)
    for name in _files(jpath):
        if name.endswith(".npy"):
            with open(os.path.join(jpath, name), "rb") as a, \
                    open(os.path.join(tpath, name), "rb") as b:
                assert a.read() == b.read(), name


def _assert_trees_equal(ttree, jtree):
    jl = jax.tree_util.tree_leaves(jtree)
    tl = [t for part in (ttree[0], ttree[1].m, ttree[1].v)
          for t in tf.tree_leaves(part)]
    tl.insert(len(list(tf.tree_leaves(ttree[0]))), ttree[1].step)
    assert len(jl) == len(tl)
    for w, g in zip(jl, tl):
        assert str(g.dtype).endswith(str(w.dtype)), (g.dtype, w.dtype)
        np.testing.assert_array_equal(_np(g), _jnp(w))


def test_port_restores_a_jax_checkpoint(tmp_path):
    jtree, ttree = _state_pair()
    jckpt.save(str(tmp_path), 3, jtree, extra={"data_cursor": 3})
    abstract = (tf.tree_map(lambda t: torch.empty_like(t, device="meta"),
                            ttree[0]),
                AdamWState(step=torch.zeros((), dtype=torch.int32),
                           m=ttree[1].m, v=ttree[1].v))
    got, manifest = ckpt.restore(str(tmp_path), None, abstract, device=CPU)
    assert manifest["step"] == 3 and manifest["extra"] == {"data_cursor": 3}
    assert isinstance(got[1], AdamWState)
    _assert_trees_equal(got, jtree)


def test_jax_restores_a_port_checkpoint(tmp_path):
    jtree, ttree = _state_pair()
    ckpt.save(str(tmp_path), 3, ttree, extra={"data_cursor": 3})
    abstract = jax.tree_util.tree_map(
        lambda l: jax.ShapeDtypeStruct(l.shape, l.dtype), jtree)
    got, manifest = jckpt.restore(str(tmp_path), None, abstract)
    assert manifest["step"] == 3
    _assert_trees_equal(ttree, got)


def test_async_checkpoint_is_taken_before_the_next_update(tmp_path):
    """The host copy is made before ``save`` returns: an in-place update
    right after it does not reach the checkpoint."""
    params = {"w": torch.ones(4, 4)}
    acp = ckpt.AsyncCheckpointer(str(tmp_path))
    acp.save(1, params)
    params["w"].mul_(3.0)
    acp.wait()
    got, _ = ckpt.restore(str(tmp_path), 1, params, device=CPU)
    assert torch.equal(got["w"], torch.ones(4, 4))


def test_restore_casts_to_the_abstract_dtype(tmp_path):
    ckpt.save(str(tmp_path), 2, {"w": torch.full((3,), 1.5,
                                                 dtype=torch.bfloat16)})
    got, _ = ckpt.restore(str(tmp_path), 2,
                          {"w": torch.empty(3, dtype=torch.float32)},
                          device=CPU)
    assert got["w"].dtype == torch.float32
    assert torch.equal(got["w"], torch.full((3,), 1.5))


def test_restore_without_a_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), None, {"w": torch.zeros(1)},
                     device=CPU)


# -- the recovery driver against the reference's ------------------------------


@pytest.mark.parametrize("fail_at", [None, {9: 0}], ids=["clean", "restart"])
def test_recovery_driver_matches_jax(weights, tmp_path, fail_at):
    jcfg, tcfg = j_get_config("llama3-8b", tiny=True), get_config(
        "llama3-8b", tiny=True)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=40)
    jo, to = jopt.AdamW(**kw), AdamW(**kw)
    jp = weights("llama3-8b")
    data = SyntheticLM(vocab=tcfg.vocab, seq_len=16, global_batch=4)

    def j_init():
        p = jax.tree_util.tree_map(jnp.asarray, jp)
        return p, jo.init(p)

    def t_init():
        p = tf.tree_from_numpy(jp, CPU)
        return p, to.init(p)

    fc = dict(ckpt_every=4)
    want = jft.run_with_recovery(
        jax.jit(jtl.make_train_step(jcfg, jo)), j_init,
        lambda i: {k: jnp.asarray(v) for k, v in data.batch_at(i).items()},
        total_steps=12, fault_cfg=jft.FaultConfig(
            ckpt_dir=str(tmp_path / "jax"), **fc), fail_at=fail_at)
    got = run_with_recovery(
        make_train_step(tcfg, to), t_init,
        lambda i: {k: torch.from_numpy(v)
                   for k, v in data.batch_at(i).items()},
        total_steps=12, fault_cfg=FaultConfig(
            ckpt_dir=str(tmp_path / "port"), **fc), fail_at=fail_at)
    assert (got.steps_run, got.restarts) == (want.steps_run, want.restarts)
    assert len(got.losses) == len(want.losses)
    np.testing.assert_allclose(got.losses, want.losses, atol=1e-4, rtol=0)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))


# -- the example --------------------------------------------------------------


def test_example_trains_on_the_cpu():
    """``examples/train_minilm_torch.py --tiny --device cpu``, with a
    failure injected: the loss falls (the example asserts it) and the run
    restarts once."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "train_minilm_torch.py"),
         "--tiny", "--device", "cpu", "--steps", "60",
         "--inject-failure", "30"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "restarts=1" in out.stdout and "(improved)" in out.stdout
