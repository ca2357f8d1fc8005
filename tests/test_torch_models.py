"""The port's model stack (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package's.

The reference's ``init_params`` tree crosses into the port as numpy arrays
(``tree_from_numpy``); both packages then run ``forward``, ``prefill`` and
``decode_step`` on the same seeded numpy inputs, for every assigned family
at its TINY size and for ``llama3-tiny``: logits within 1e-5 (f32).  The
MoE dispatch is held to the reference where capacity drops tokens, the SSD
chunking at a prime T (chunk 1) and at a multiple of the chunk, and a cache
write past the end raises where the reference clamps.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.registry import ASSIGNED, CONFIGS  # noqa: E402
from repro_torch.models import attention as att  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

ARCHS = ASSIGNED + ["llama3-8b"]
TOL = dict(rtol=1e-5, atol=1e-5)
CPU = "cpu"
B, T, EXTRA = 2, 12, 3
# the reference's functions, jitted (a config is static): eager JAX compiles
# op by op, several times slower on these sizes
J_INIT = jax.jit(jtf.init_params, static_argnums=0)
J_FORWARD = jax.jit(jtf.forward, static_argnums=2)
J_PREFILL = jax.jit(jtf.prefill, static_argnums=2)
J_DECODE = jax.jit(jtf.decode_step, static_argnums=4)
J_SSM = jax.jit(jssm.ssm_apply, static_argnums=2)
J_SSM_STEP = jax.jit(jssm.ssm_decode_step, static_argnums=3)
J_MOE = jax.jit(jmoe.moe_apply, static_argnums=2)
J_ATTN = {False: jax.jit(jatt.attn_apply, static_argnums=2),
          True: jax.jit(jatt.mla_apply, static_argnums=2)}


def _jax_tree(cfg):
    return jax.tree_util.tree_map(np.asarray,
                                  J_INIT(cfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def weights():
    """arch -> (cfg pair, reference params, the port's carried copy)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg, tcfg = j_get_config(arch, tiny=True), get_config(arch,
                                                                   tiny=True)
            jp = _jax_tree(jcfg)
            cache[arch] = (jcfg, tcfg, jp, tf.tree_from_numpy(jp, CPU))
        return cache[arch]
    return get


def _inputs(cfg, n_tokens):
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab, (B, n_tokens)).astype(np.int32)
    aux = None
    if cfg.family == "encdec":
        aux = rng.standard_normal((B, cfg.n_frames, cfg.d_model))
    if cfg.family == "vlm":
        aux = rng.standard_normal((B, cfg.n_image_tokens, cfg.d_model))
    return toks, None if aux is None else aux.astype(np.float32)


def _batches(cfg, toks, aux):
    jb, tb = {"tokens": jnp.asarray(toks)}, {
        "tokens": torch.from_numpy(toks).long()}
    key = {"encdec": "frames", "vlm": "images"}.get(cfg.family)
    if key:
        jb[key], tb[key] = jnp.asarray(aux), torch.from_numpy(aux)
    return jb, tb


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(weights, arch):
    jcfg, tcfg, jp, tp = weights(arch)
    toks, aux = _inputs(tcfg, T)
    jb, tb = _batches(tcfg, toks, aux)
    want = np.asarray(J_FORWARD(jp, jb, jcfg))
    got = tf.forward(tp, tb, tcfg)
    assert got.shape == (B, T, tcfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(weights, arch):
    """Prefill of T tokens, then three decode steps, the caches carried
    (written in place in the port) — logits within 1e-5 at every call."""
    jcfg, tcfg, jp, tp = weights(arch)
    toks, aux = _inputs(tcfg, T + EXTRA)
    jc = jtf.init_caches(jcfg, B, T + EXTRA, dtype=jnp.float32)
    tc = tf.init_caches(tcfg, B, T + EXTRA, dtype=torch.float32, device=CPU)
    jl, jc, jaux = J_PREFILL(jp, jnp.asarray(toks[:, :T]), jcfg, jc,
                               aux_input=None if aux is None
                               else jnp.asarray(aux))
    tl, tc2, taux = tf.prefill(tp, torch.from_numpy(toks[:, :T]).long(),
                               tcfg, tc, aux_input=None if aux is None
                               else torch.from_numpy(aux))
    assert tc2 is tc
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert sorted(taux) == sorted(jaux)
    for i in range(EXTRA):
        jl, jc = J_DECODE(jp, jnp.asarray(toks[:, T + i: T + i + 1]), jc,
                          jnp.asarray(T + i), jcfg, aux_caches=jaux)
        tl, tc = tf.decode_step(tp, torch.from_numpy(
            toks[:, T + i: T + i + 1]).long(), tc, T + i, tcfg,
            aux_caches=taux)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    # the caches the port wrote in place are the reference's
    for (jk, jv), (tk, tv) in zip(_flat(jax.tree_util.tree_map(
            np.asarray, jc)), _flat(tc)):
        assert jk == tk
        np.testing.assert_allclose(tv.numpy(), jv, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The port on its own (its own init): cached decode = full forward,
    as the reference's test of the same name."""
    cfg = get_config(arch, tiny=True)
    params = tf.init_params(cfg, 0, device=CPU)
    toks, aux = _inputs(cfg, T + EXTRA)
    _, tb = _batches(cfg, toks, aux)
    taux = None if aux is None else torch.from_numpy(aux)
    full = tf.forward(params, tb, cfg)
    caches = tf.init_caches(cfg, B, T + EXTRA, dtype=torch.float32,
                            device=CPU)
    lg, caches, aux_c = tf.prefill(params, tb["tokens"][:, :T], cfg, caches,
                                   aux_input=taux)
    torch.testing.assert_close(lg[:, 0], full[:, T - 1], rtol=1e-4,
                               atol=1e-4)
    for i in range(EXTRA):
        ld, caches = tf.decode_step(params, tb["tokens"][:, T + i: T + i + 1],
                                    caches, T + i, cfg, aux_caches=aux_c)
        torch.testing.assert_close(ld[:, 0], full[:, T + i], rtol=1e-4,
                                   atol=2e-4)


def _flat(tree, path=()):
    """(key path, leaf) in sorted-key order (the reference's flatten)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flat(tree[k],
                                                         path + (k,))]
    return [("/".join(path), tree)]


def _np_dtype(dtype) -> str:
    return str(dtype).replace("torch.", "")


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_trees_match_reference(arch, tiny):
    """``abstract_params`` (and, at TINY size, ``init_params``) give the
    reference's keys, shapes and dtypes; ``param_count`` is within 5 % of
    the port's leaves where the reference's own test holds it (TINY)."""
    cfg = get_config(arch, tiny=tiny)
    jcfg = j_get_config(arch, tiny=tiny)
    want = [(k, tuple(a.shape), str(a.dtype))
            for k, a in _flat(jtf.abstract_params(jcfg))]
    abstract = tf.abstract_params(cfg)
    got = [(k, tuple(a.shape), _np_dtype(a.dtype))
           for k, a in _flat(abstract)]
    assert got == want
    assert all(a.device.type == "meta" for _, a in _flat(abstract))
    if tiny:
        concrete = tf.init_params(cfg, torch.Generator().manual_seed(1),
                                  device=CPU)
        assert [(k, tuple(a.shape), _np_dtype(a.dtype))
                for k, a in _flat(concrete)] == want
        actual = sum(a.numel() for _, a in _flat(concrete))
        if arch in ("qwen3-14b", "olmoe-1b-7b", "mamba2-2.7b"):
            assert abs(actual - cfg.param_count()) / actual < 0.05, (
                actual, cfg.param_count())


def test_configs_are_the_reference_configs():
    from repro.configs.registry import ASSIGNED as J_ASSIGNED
    from repro.configs.registry import CONFIGS as J_CONFIGS
    assert ASSIGNED == J_ASSIGNED and sorted(CONFIGS) == sorted(J_CONFIGS)
    for name, cfg in CONFIGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(J_CONFIGS[name])
        assert cfg.param_count() == J_CONFIGS[name].param_count()
        assert (cfg.active_param_count()
                == J_CONFIGS[name].active_param_count())


def test_window_schedule_matches_reference():
    for tiny in (True, False):
        cfg = get_config("hymba-1.5b", tiny=tiny)
        want = np.asarray(jtf._window_schedule(j_get_config("hymba-1.5b",
                                                            tiny=tiny)))
        np.testing.assert_array_equal(np.asarray(tf._window_schedule(cfg)),
                                      want)


def test_tree_from_numpy_keeps_bfloat16_bits():
    cfg = dataclasses.replace(j_get_config("qwen3-14b", tiny=True),
                              param_dtype="bfloat16")
    jp = _jax_tree(cfg)
    tp = tf.tree_from_numpy(jp, CPU)
    for (jk, ja), (tk, ta) in zip(_flat(jp), _flat(tp)):
        assert jk == tk and ta.dtype == torch.bfloat16
        np.testing.assert_array_equal(ta.view(torch.int16).numpy(),
                                      ja.view(np.int16))


# -- MoE: the dispatch with capacity drops ----------------------------------


def test_moe_drops_match_jax():
    """The default capacity factor (1.25) at N·K = 512 against E·8 = 64,
    with tokens that share a component, so the router sends most of them
    to the same experts and the capacity really drops (token, k) pairs:
    the outputs, the load-balance loss and the expert-parallel entry point
    all equal the reference's."""
    jcfg = dataclasses.replace(j_get_config("olmoe-1b-7b", tiny=True),
                               capacity_factor=1.25)
    tcfg = dataclasses.replace(get_config("olmoe-1b-7b", tiny=True),
                               capacity_factor=1.25, moe_impl="ep_local")
    jp = jax.tree_util.tree_map(
        np.asarray, jmoe.moe_init(jax.random.PRNGKey(4), jcfg))
    tp = tf.tree_from_numpy(jp, CPU)
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(tcfg.d_model)
         + 0.3 * rng.standard_normal((4, 64, tcfg.d_model))).astype(
        np.float32)
    N = x.shape[0] * x.shape[1]
    C = moe.capacity(N, tcfg)
    assert C == jmoe.capacity(N, jcfg) == 80
    # the port's routing (the reference's: stable top-k) over-fills experts
    probs = torch.softmax(torch.from_numpy(x).reshape(N, -1)
                          @ tp["router"], -1)
    _, idx = moe.top_k(probs, tcfg.top_k)
    counts = torch.bincount(idx.reshape(-1), minlength=tcfg.n_experts)
    assert int(counts.max()) > C, counts
    want = np.asarray(J_MOE(jp, jnp.asarray(x), jcfg))
    got = moe.moe_apply(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(
        moe.moe_apply_ep_local(tp, torch.from_numpy(x), tcfg).numpy(),
        got.numpy())
    np.testing.assert_allclose(
        float(moe.aux_load_balance_loss(tp, torch.from_numpy(x), tcfg)),
        float(jmoe.aux_load_balance_loss(jp, jnp.asarray(x), jcfg)),
        **TOL)


def test_top_k_breaks_ties_toward_the_lower_index():
    probs = np.array([[0.25, 0.25, 0.1, 0.25, 0.15],
                      [0.2, 0.2, 0.2, 0.2, 0.2]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = moe.top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# -- SSD chunking --------------------------------------------------------------


@pytest.mark.parametrize("n_tokens,a_shift", [(13, 0.0), (12, 0.0),
                                              (12, 7.0)],
                         ids=["prime", "chunk-multiple",
                              "overflowing-decay"])
def test_ssd_matches_jax(n_tokens, a_shift):
    """ssm_apply at a prime T (the chunk is 1, 13 chunks) and at a multiple
    of the chunk (4, 3 chunks); and with decays so steep that the masked
    upper triangle of exp(dseg) overflows to inf before the where drops
    it.  Outputs and final states within 1e-5, then one decode step from
    the final state."""
    jcfg = dataclasses.replace(j_get_config("mamba2-2.7b", tiny=True),
                               ssm_chunk=4)
    tcfg = dataclasses.replace(get_config("mamba2-2.7b", tiny=True),
                               ssm_chunk=4)
    assert ssm.chunk_len(n_tokens, 4) == (1 if n_tokens == 13 else 4)
    jp = jax.tree_util.tree_map(np.asarray,
                                jssm.ssm_init(jax.random.PRNGKey(2), jcfg))
    jp["A_log"] = (jp["A_log"] + a_shift).astype(np.float32)
    tp = tf.tree_from_numpy(jp, CPU)
    rng = np.random.default_rng(n_tokens)
    x = rng.standard_normal((2, n_tokens, tcfg.d_model)).astype(np.float32)
    jy, jstate = J_SSM(jp, jnp.asarray(x), jcfg)
    ty, tstate = ssm.ssm_apply(tp, torch.from_numpy(x), tcfg)
    assert torch.isfinite(ty).all()
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate), **TOL)
    x1 = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    jst = jssm.empty_ssm_state(jcfg, 2, jnp.float32)
    jst = {"ssm": jstate, "conv": jst["conv"]}
    tst = {"ssm": tstate, "conv": torch.from_numpy(np.array(jst["conv"]))}
    jo, jn = J_SSM_STEP(jp, jnp.asarray(x1), jst, jcfg)
    to, tn = ssm.ssm_decode_step(tp, torch.from_numpy(x1), tst, tcfg)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tn["ssm"].numpy(), np.asarray(jn["ssm"]),
                               **TOL)


# -- caches ----------------------------------------------------------------------


@pytest.mark.parametrize("mla", [False, True], ids=["gqa", "mla"])
def test_cache_write_past_the_end_raises_where_jax_clamps(mla):
    """At ``cache_pos = max_len`` the reference's ``dynamic_update_slice``
    clamps the start and overwrites the last row; the port raises
    ``IndexError``.  At ``max_len - 1`` both write the last row and agree."""
    arch = "deepseek-v3-671b" if mla else "qwen3-14b"
    jcfg, tcfg = j_get_config(arch, tiny=True), get_config(arch, tiny=True)
    S = 6
    jp = jax.tree_util.tree_map(np.asarray, (
        jatt.mla_init if mla else jatt.attn_init)(jax.random.PRNGKey(3),
                                                  jcfg))
    tp = tf.tree_from_numpy(jp, CPU)
    x = np.random.default_rng(0).standard_normal(
        (1, 1, tcfg.d_model)).astype(np.float32)
    japply = J_ATTN[mla]
    tapply = att.mla_apply if mla else att.attn_apply
    extra = {} if mla else dict(rope_cs=None)
    for pos in (S - 1, S):
        jc = jatt.empty_cache(jcfg, 1, S, jnp.float32)
        tc = att.empty_cache(tcfg, 1, S, torch.float32, device=CPU)
        jy, _ = japply(jp, jnp.asarray(x), jcfg, q_pos=jnp.asarray([pos]),
                       cache=jc, cache_pos=pos, kv_valid=pos + 1, **extra)
        if pos == S:
            assert np.isfinite(np.asarray(jy)).all()  # clamped, runs on
            with pytest.raises(IndexError, match="past a cache"):
                tapply(tp, torch.from_numpy(x), tcfg,
                       q_pos=torch.tensor([pos]), cache=tc, cache_pos=pos,
                       kv_valid=pos + 1, **extra)
        else:
            ty, _ = tapply(tp, torch.from_numpy(x), tcfg,
                           q_pos=torch.tensor([pos]), cache=tc,
                           cache_pos=pos, kv_valid=pos + 1, **extra)
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


def test_decode_past_the_cache_raises():
    cfg = get_config("llama3-8b", tiny=True)
    params = tf.init_params(cfg, 0, device=CPU)
    caches = tf.init_caches(cfg, 1, 4, dtype=torch.float32, device=CPU)
    tf.prefill(params, torch.tensor([[1, 2, 3, 4]]), cfg, caches)
    with pytest.raises(IndexError, match="past a cache"):
        tf.decode_step(params, torch.tensor([[5]]), caches, 4, cfg)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = get_config("llama3-8b", tiny=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tf.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tf.init_caches(cfg, 1, 4, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tf.tree_from_numpy({"w": np.zeros(2, np.float32)})
