"""The port's bridge and ``DirectEngine`` against the JAX package's (the
port of ``tests/test_system.py``): the relational engine and the dense
engine produce identical generations from identical weights, across
in-memory and disk+mem (paged) residencies, in both packages."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core.bridge import llama_params_to_tree as j_to_tree  # noqa: E402
from repro.core.bridge import spec_to_config as j_spec_to_config  # noqa: E402
from repro.core.llama_graph import LlamaSpec as JSpec  # noqa: E402
from repro.core.llama_graph import init_llama_params  # noqa: E402
from repro.serving.engine import DirectEngine as JDirect  # noqa: E402
from repro_torch.core.bridge import (llama_params_to_tree,  # noqa: E402
                                     spec_to_config)
from repro_torch.core.llama_graph import LlamaSpec  # noqa: E402
from repro_torch.serving.engine import (DirectEngine,  # noqa: E402
                                        RelationalEngine)
from repro_torch.serving.pager import WeightPager  # noqa: E402

SPEC_ARGS = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv=2,
                 d_ff=64, rope_theta=10000.0)
J_SPEC, SPEC = JSpec(**SPEC_ARGS), LlamaSpec(**SPEC_ARGS)
PROMPT, NEW = [5, 9, 2, 7], 6
CPU = "cpu"


@pytest.fixture(scope="module")
def weights():
    return init_llama_params(J_SPEC, seed=3)


@pytest.fixture(scope="module")
def jax_direct(weights):
    """The reference's DirectEngine generation (in memory)."""
    eng = JDirect(j_spec_to_config(J_SPEC), j_to_tree(weights, J_SPEC),
                  residency="in_memory", max_len=32)
    return eng.generate(PROMPT, max_new_tokens=NEW)


@pytest.fixture(scope="module")
def direct_tokens(weights, jax_direct):
    eng = DirectEngine(spec_to_config(SPEC),
                       llama_params_to_tree(weights, SPEC, device=CPU),
                       residency="in_memory", max_len=32, device=CPU)
    res = eng.generate(PROMPT, max_new_tokens=NEW)
    assert res.tokens == jax_direct.tokens
    return res.tokens


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flat(tree[k],
                                                         path + (k,))]
    return [("/".join(path), tree)]


def test_spec_to_config_matches_reference():
    for dtype in ("float32", "bfloat16"):
        assert (dataclasses.asdict(spec_to_config(SPEC, dtype))
                == dataclasses.asdict(j_spec_to_config(J_SPEC, dtype)))


@pytest.mark.parametrize("as_tensors", [False, True],
                         ids=["numpy", "tensors"])
def test_params_to_tree_matches_reference(weights, as_tensors):
    """Leaf by leaf: the same keys, shapes, dtypes and values (the
    transposes and stacking are the reference's), from numpy arrays or
    from tensors; every leaf is a contiguous tensor of its own."""
    src = ({k: torch.from_numpy(v) for k, v in weights.items()}
           if as_tensors else weights)
    got = _flat(llama_params_to_tree(src, SPEC, device=CPU))
    want = _flat(jax.tree_util.tree_map(np.asarray,
                                        j_to_tree(weights, J_SPEC)))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        assert g.is_contiguous() and tuple(g.shape) == w.shape, k
        np.testing.assert_array_equal(g.numpy(), w)
        assert not any(g.data_ptr() == torch.as_tensor(v).data_ptr()
                       for v in src.values()), k


def test_direct_inmemory_matches_jax(jax_direct, direct_tokens):
    assert direct_tokens == jax_direct.tokens


def test_direct_result_fields(weights, jax_direct):
    eng = DirectEngine(spec_to_config(SPEC),
                       llama_params_to_tree(weights, SPEC, device=CPU),
                       max_len=32, device=CPU)
    res = eng.generate(PROMPT, max_new_tokens=NEW)
    assert res.ttft_s > 0 and res.tpot_s > 0 and res.pager_stats is None
    assert res.peak_working_set == jax_direct.peak_working_set


@pytest.mark.parametrize("disk", [True, False], ids=["disk", "host"])
def test_direct_paged_matches_jax(weights, direct_tokens, tmp_path, disk):
    """Disk+mem DirectEngine (a 48 KiB working set against an 89 KiB
    tree): the reference's tokens, and the pager's misses, evictions,
    bytes and peak equal to the reference's pager (the same leaves walked
    in the same sorted-key order)."""
    jeng = JDirect(j_spec_to_config(J_SPEC), j_to_tree(weights, J_SPEC),
                   residency="paged", budget_bytes=48 * 1024,
                   disk_dir=str(tmp_path / "jax"), max_len=32)
    want = jeng.generate(PROMPT, max_new_tokens=NEW)
    eng = DirectEngine(spec_to_config(SPEC),
                       llama_params_to_tree(weights, SPEC, device=CPU),
                       residency="paged", budget_bytes=48 * 1024,
                       disk_dir=str(tmp_path / "torch") if disk else None,
                       max_len=32, device=CPU)
    res = eng.generate(PROMPT, max_new_tokens=NEW)
    assert res.tokens == want.tokens == direct_tokens
    assert res.pager_stats == want.pager_stats
    assert res.pager_stats["misses"] > 0 and res.pager_stats["evictions"] > 0
    assert res.peak_working_set == want.peak_working_set <= 48 * 1024
    assert eng.pager._clock == jeng.pager._clock
    assert sorted(eng.pager._cold) == sorted(jeng.pager._cold)


def test_add_tree_walks_keys_sorted():
    """``add_tree`` registers leaves under ``prefix`` + the ``/``-joined
    path, in sorted-key order at every level (the reference's flatten),
    skipping empty subtrees."""
    tree = {"b": {"z": np.zeros(2, np.float32), "a": np.ones(3, np.float32)},
            "a": torch.arange(4.0), "c": {}}
    pager = WeightPager(1 << 20, device=CPU)
    pager.add_tree(tree, prefix="p:")
    assert list(pager._cold) == ["p:a", "p:b/a", "p:b/z"]
    np.testing.assert_array_equal(pager.get("p:b/a").numpy(), np.ones(3))


def test_relational_inmemory_matches_direct(weights, direct_tokens):
    """The compiled SQL-equivalent pipeline is the same model."""
    eng = RelationalEngine(SPEC, weights, chunk_size=8,
                           residency="in_memory", max_len=32, device=CPU)
    res = eng.generate(PROMPT, max_new_tokens=NEW)
    assert res.tokens == direct_tokens
    assert res.ttft_s > 0 and res.tpot_s > 0


def test_relational_paged_matches_direct(weights, direct_tokens, tmp_path):
    """Disk+mem mode (memmap cold store + bounded working set) is
    semantics-preserving (§4.3)."""
    eng = RelationalEngine(SPEC, weights, chunk_size=8, residency="paged",
                           budget_bytes=64 * 1024,
                           disk_dir=str(tmp_path / "db"), max_len=32,
                           device=CPU)
    res = eng.generate(PROMPT, max_new_tokens=NEW)
    assert res.tokens == direct_tokens
    assert res.pager_stats["misses"] > 0
    assert res.pager_stats["evictions"] > 0


@pytest.mark.parametrize("cs", [4, 8, 16])
def test_chunk_size_only_affects_speed(weights, direct_tokens, cs):
    """Tab. 1's knob: every chunk size yields the dense engine's tokens."""
    eng = RelationalEngine(SPEC, weights, chunk_size=cs,
                           residency="in_memory", max_len=32, device=CPU)
    assert eng.generate(PROMPT, NEW).tokens == direct_tokens


def test_direct_engine_defaults_to_the_card(weights):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    tree = llama_params_to_tree(weights, SPEC, device=CPU)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DirectEngine(spec_to_config(SPEC), tree, max_len=32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        llama_params_to_tree(weights, SPEC)
