"""The port's dry-run and roofline (``repro_torch.analysis.roofline``,
``repro_torch.launch.{specs,dryrun,hillclimb}``) against the reference's.

- Every case of ``tests/test_dryrun_units.py``, on the port with the H100
  constants; the collective parser's cases read the dry-run counter's
  records (the port has no HLO text).
- Parity: ``SHAPES``, ``cell_supported`` on all 40 cells, the input specs
  and ``build_cell``'s arguments (shapes and dtypes against
  ``jax.eval_shape``) for a dense, an MoE, an encdec and a VLM tiny
  config, ``model_flops_for``, ``format_table``'s text, ``_depth_reduced``,
  ``_big_group_layers`` and ``EXPERIMENTS``, all exactly.
- The JAX oracle (one subprocess, 4 forced host devices, a 2×2 mesh of
  ``AxisType.Auto`` axes) compiles the reference's tiny train cell: the
  port's per-device argument bytes equal its ``memory_analysis()``
  exactly.  FLOPs and bytes are counted differently (the matmul,
  convolution and attention families against every HLO op; unfused eager
  ops against fused HLO), so their ratios are printed and held within
  [0.25, 4].
- Invariants of the port: per-device FLOPs equal a hand count; on a (4, 1)
  data-only mesh they are a quarter of world size 1's; ``full`` equals
  ``extrapolate`` in FLOPs, bytes and collectives; c10d's in-place,
  DTensor's functional and point-to-point collectives are all counted.
- ``python -m repro_torch.launch.dryrun --device cpu`` on a TINY config
  writes the reference's record keys; importing the launch modules sets up
  no process group.

Meshes run on a one-process ``"fake"`` process group (``fake_world``),
destroyed after each case.
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

import torch.distributed as dist  # noqa: E402

from repro.analysis import roofline as jrl  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402

# the reference's launch modules set XLA_FLAGS (512 host devices) when
# imported; put this process's value back before any JAX backend starts
_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdr  # noqa: E402
from repro.launch import hillclimb as jhc  # noqa: E402
if _XLA_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS

from repro_torch.analysis.roofline import (HBM_BW, LINK_BW,  # noqa: E402
                                           PEAK_FLOPS, Roofline,
                                           collective_bytes, format_table,
                                           model_flops_for)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.registry import ASSIGNED  # noqa: E402
from repro_torch.distributed.sharding import single_pod_rules  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch import hillclimb as hc  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.launch.specs import (SHAPES,  # noqa: E402
                                      aux_cache_specs, aux_input_spec,
                                      batch_specs, build_cell, cache_specs,
                                      cell_supported)

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute", "collective-broadcast")
# a dense, an MoE, an encdec and a VLM tiny config
SPEC_ARCHS = ["olmo-1b", "olmoe-1b-7b", "whisper-small",
              "llama-3.2-vision-90b"]
# the oracle's ratios of the port's count to XLA's on its tiny train cell
RATIO_RANGE = (0.25, 4.0)


def _bf16(cfg):
    """A TINY config in bf16: the reference's caches are bf16, and the
    port's attention takes one dtype (JAX promotes f32 · bf16)."""
    return dataclasses.replace(cfg, dtype="bfloat16", param_dtype="bfloat16")


# -- the collective parser, on the counter's records ------------------------

RECORDS = [
    {"op": "c10d.allreduce_", "bytes": 1024 * 512 * 2},
    {"op": "_c10d_functional.all_gather_into_tensor", "bytes": 64 * 128 * 4},
    {"op": "_c10d_functional.reduce_scatter_tensor", "bytes": 64 * 128 * 4},
    {"op": "c10d.send", "bytes": 32 * 32 * 2},
    {"op": "c10d.recv_", "bytes": 0},
]


class TestCollectiveParser:
    def test_counts_each_kind(self):
        out = collective_bytes(RECORDS)
        assert out["all-reduce"] == 1024 * 512 * 2
        assert out["all-gather"] == 64 * 128 * 4
        assert out["reduce-scatter"] == 64 * 128 * 4
        assert out["collective-permute"] == 32 * 32 * 2
        assert out["total"] == sum(out[k] for k in KINDS)
        assert set(out) == set(jrl.collective_bytes(""))

    def test_ignores_non_collectives(self):
        out = collective_bytes([
            {"op": "_c10d_functional.wait_tensor", "bytes": 4096},
            {"op": "c10d.barrier", "bytes": 4},
            {"op": "aten.mm", "bytes": 8 * 8 * 4}])
        assert out["total"] == 0

    def test_real_counted_step(self):
        """Count an actual single-device product: no collectives."""
        x = torch.randn(8, 8)
        with dr.StepCounter() as counter:
            x @ x.T
        assert counter.flops == 2 * 8 * 8 * 8
        assert collective_bytes(counter.records)["total"] == 0


# -- the roofline's arithmetic, H100 constants -------------------------------


class TestRooflineMath:
    def _rl(self, flops, bytes_, coll):
        return Roofline(arch="a", shape="s", mesh="m", flops_per_dev=flops,
                        bytes_per_dev=bytes_, coll_bytes_per_dev=coll,
                        coll_breakdown={}, model_flops=flops / 2)

    def test_h100_constants(self):
        assert (PEAK_FLOPS, HBM_BW, LINK_BW) == (989e12, 3.35e12, 450e9)

    def test_terms(self):
        rl = self._rl(PEAK_FLOPS, HBM_BW, LINK_BW)
        assert rl.t_compute == pytest.approx(1.0)
        assert rl.t_memory == pytest.approx(1.0)
        assert rl.t_collective == pytest.approx(1.0)

    def test_bottleneck_selection(self):
        rl = self._rl(PEAK_FLOPS, 10 * HBM_BW, LINK_BW)
        assert rl.bottleneck == "memory"
        assert rl.bound_time == pytest.approx(10.0)
        assert rl.roofline_fraction == pytest.approx(0.1)

    def test_useful_ratio(self):
        rl = self._rl(2e12, 1, 1)
        assert rl.useful_flops_ratio == pytest.approx(0.5)

    def test_model_flops_train_vs_decode(self):
        cfg = get_config("qwen3-14b")
        tr = model_flops_for(cfg, SHAPES["train_4k"], 256, "train")
        de = model_flops_for(cfg, SHAPES["decode_32k"], 256, "decode")
        # train: 6·N·(4096·256) / chips;  decode: 2·N·128 / chips
        assert tr / de == pytest.approx(3 * 4096 * 256 / 128, rel=1e-6)

    def test_row_keys_match_reference(self):
        kw = dict(arch="a", shape="s", mesh="m", flops_per_dev=3.0,
                  bytes_per_dev=5.0, coll_bytes_per_dev=7.0,
                  coll_breakdown={}, model_flops=1.0)
        assert list(Roofline(**kw).row()) == list(jrl.Roofline(**kw).row())


# -- the cell policy -----------------------------------------------------------


class TestCellPolicy:
    def test_long500k_skips_full_attention(self):
        ok, why = cell_supported(get_config("qwen3-14b"), "long_500k")
        assert not ok and "full-attention" in why

    @pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b"])
    def test_long500k_runs_subquadratic(self, arch):
        ok, _ = cell_supported(get_config(arch), "long_500k")
        assert ok

    def test_all_40_cells_accounted(self):
        """10 archs × 4 shapes: every cell either supported or documented."""
        total = supported = skipped = 0
        for arch in ASSIGNED:
            for shape in SHAPES:
                total += 1
                ok, why = cell_supported(get_config(arch), shape)
                supported += ok
                skipped += (not ok) and bool(why)
        assert total == 40
        assert supported + skipped == 40
        assert skipped == 8  # long_500k × 8 full-attention archs

    def test_batch_specs_stub_frontends(self):
        wh = batch_specs(get_config("whisper-small"), 4096, 256)
        assert wh["frames"].shape == (256, 1500, 768)
        vl = batch_specs(get_config("llama-3.2-vision-90b"), 4096, 256)
        assert vl["images"].shape == (256, 6404, 8192)


# -- parity with the reference -------------------------------------------------


def test_shapes_match_reference():
    assert SHAPES == jspecs.SHAPES


@pytest.mark.parametrize("arch", ASSIGNED)
def test_cell_supported_matches_reference(arch):
    for shape in SHAPES:
        assert cell_supported(get_config(arch), shape) == \
            jspecs.cell_supported(j_get_config(arch), shape)


def _flat_torch(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flat_torch(tree[k], f"{prefix}/{k}")
        return out
    if isinstance(tree, tuple):
        out = []
        for i, v in enumerate(tree):
            out += _flat_torch(v, f"{prefix}/{i}")
        return out
    return [(prefix, tuple(tree.shape), str(tree.dtype).split(".")[-1])]


def _flat_jax(tree):
    leaves = jax.tree_util.tree_leaves(tree)
    return [(tuple(l.shape), str(l.dtype)) for l in leaves]


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_cell_args_match_reference(arch, shape):
    """``build_cell``'s arguments, leaf for leaf in JAX's order, the same
    shapes and dtypes as the reference's abstract arguments."""
    cfg, jcfg = get_config(arch, tiny=True), j_get_config(arch, tiny=True)
    cell, jcell = build_cell(cfg, shape), jspecs.build_cell(jcfg, shape)
    assert (cell.kind, cell.donate) == (jcell.kind, jcell.donate)
    got = [(s, d) for _, s, d in _flat_torch(cell.args)]
    assert got == _flat_jax(jcell.args)
    assert all(t.device.type == "meta" for t in dr._tensors(cell.args))


@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_input_specs_match_reference(arch):
    cfg, jcfg = get_config(arch, tiny=True), j_get_config(arch, tiny=True)
    for b in (1, 4):
        got = [(s, d) for _, s, d in _flat_torch(cache_specs(cfg, b, 16))]
        assert got == _flat_jax(jspecs.cache_specs(jcfg, b, 16))
        aux, jaux = aux_cache_specs(cfg, b), jspecs.aux_cache_specs(jcfg, b)
        assert (aux is None) == (jaux is None)
        if aux is not None:
            assert [(s, d) for _, s, d in _flat_torch(aux)] == _flat_jax(jaux)
        inp, jinp = aux_input_spec(cfg, b), jspecs.aux_input_spec(jcfg, b)
        assert (inp is None) == (jinp is None)
        if inp is not None:
            assert tuple(inp.shape) == jinp.shape
        got_b = batch_specs(cfg, 16, b)
        want_b = jspecs.batch_specs(jcfg, 16, b)
        assert sorted(got_b) == sorted(want_b)
        for k in got_b:
            assert tuple(got_b[k].shape) == want_b[k].shape
            assert str(got_b[k].dtype).split(".")[-1] == str(want_b[k].dtype)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_model_flops_match_reference(arch):
    for shape, info in SHAPES.items():
        for chips in (256, 512):
            assert model_flops_for(get_config(arch), info, chips,
                                   info["kind"]) == jrl.model_flops_for(
                j_get_config(arch), info, chips, info["kind"])


def test_format_table_matches_reference():
    kw = dict(arch="olmo-1b", shape="decode_32k", mesh="16x16",
              flops_per_dev=3.3e9, bytes_per_dev=6.8e9,
              coll_bytes_per_dev=3.7e6, coll_breakdown={},
              model_flops=1.2e9)
    rows = [Roofline(**kw).row(),
            Roofline(**dict(kw, flops_per_dev=0.0)).row(),
            Roofline(**dict(kw, shape="train_4k", bytes_per_dev=1.0,
                            coll_bytes_per_dev=1e12)).row()]
    assert format_table(rows) == jrl.format_table(rows)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_depth_reduction_matches_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for a in (4, 8):
        assert dr._big_group_layers(cfg, a) == jdr._big_group_layers(jcfg, a)
        assert dataclasses.asdict(dr._depth_reduced(cfg, a)) == \
            dataclasses.asdict(jdr._depth_reduced(jcfg, a))


def test_experiments_match_reference():
    assert hc.EXPERIMENTS == jhc.EXPERIMENTS
    assert [e["tag"] for e in hc.EXPERIMENTS] == [
        "A1_ce_onehot", "A2_ce_onehot+embed_tp", "A3_seq_parallel",
        "A4_seq_parallel+ce_onehot", "A5_seq_par+no_remat", "B1_ep_local",
        "B2_ep_local+ce", "B3_ep_local+seq_par", "B4_deepseek_ep_local",
        "C1_ep_all_chips", "C2_ep_all+weights_2d", "C3_ep_all+kv_seq"]


# -- the JAX oracle ------------------------------------------------------------

ORACLE = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
from repro.launch import dryrun as jdr  # sets 512 devices at import
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import numpy as np
from jax.sharding import AxisType, Mesh
from repro.configs import get_config
from repro.distributed.sharding import single_pod_rules

mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"),
            axis_types=(AxisType.Auto,) * 2)
compiled, m = jdr._compile_cell(get_config(sys.argv[1], tiny=True),
                                sys.argv[2], mesh,
                                single_pod_rules(fsdp=True))
print("RESULTS " + json.dumps(dict(m, mem=jdr._mem_dict(
    compiled.memory_analysis()))))
"""


def _oracle(arch, shape):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", ORACLE, arch, shape],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULTS ")]
    return json.loads(line[-1][len("RESULTS "):])


def test_train_cell_against_the_jax_oracle():
    """olmo-1b's TINY train cell on a 2×2 mesh (FSDP rules)."""
    want = _oracle("olmo-1b", "train_4k")
    with dr.fake_world(4):
        mesh = make_test_mesh(2, 2, device_type="cpu")
        mem, got = dr._compile_cell(get_config("olmo-1b", tiny=True),
                                    "train_4k", mesh,
                                    single_pod_rules(fsdp=True),
                                    device_type="cpu")
    assert mem.argument_size_in_bytes == \
        want["mem"]["argument_size_in_bytes"]
    ratios = {k: got[k] / want[k] for k in ("flops", "bytes")}
    print(f"port / XLA on olmo-tiny train_4k, 2x2: FLOPs "
          f"{ratios['flops']:.4f} ({got['flops']:.6e} / {want['flops']:.6e})"
          f", bytes {ratios['bytes']:.4f} ({got['bytes']:.6e} / "
          f"{want['bytes']:.6e}), collectives {got['coll']['total']:.6e} / "
          f"{want['coll']['total']:.6e}")
    for k, r in ratios.items():
        assert RATIO_RANGE[0] <= r <= RATIO_RANGE[1], (k, r)


# -- invariants of the port ------------------------------------------------------


def _decode_hand_flops(cfg, B, S):
    """The matmul and attention FLOPs of one decode step of a dense
    config on one device: per layer Q, K, V, O, the SwiGLU MLP, QKᵀ and
    P·V over the whole cache; then the tied lm_head."""
    d, H, Hkv, dh, f = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim, \
        cfg.d_ff
    layer = (2 * B * d * H * dh * 2 + 2 * B * d * Hkv * dh * 2
             + 3 * 2 * B * d * f + 2 * 2 * B * H * S * dh)
    return cfg.n_layers * layer + 2 * B * d * cfg.vocab


def test_decode_flops_equal_a_hand_count():
    cfg = _bf16(get_config("olmo-1b", tiny=True))
    info = SHAPES["decode_32k"]
    _, m = dr._compile_cell(cfg, "decode_32k", None,
                            single_pod_rules(), device_type="cpu")
    assert m["flops"] == _decode_hand_flops(cfg, info["global_batch"],
                                            info["seq_len"])
    assert m["coll"]["total"] == 0


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_data_parallel_flops_are_a_quarter(shape):
    """On a (4, 1) data-only mesh every product splits its batch 4 ways."""
    cfg = get_config("olmo-1b", tiny=True)
    if shape != "train_4k":
        cfg = _bf16(cfg)
    rules = single_pod_rules(fsdp=shape == "train_4k")
    _, one = dr._compile_cell(cfg, shape, None, rules, device_type="cpu")
    with dr.fake_world(4):
        mesh = make_test_mesh(4, 1, device_type="cpu")
        mem, four = dr._compile_cell(cfg, shape, mesh, rules,
                                     device_type="cpu")
    assert 4 * four["flops"] == one["flops"]
    assert mem.argument_size_in_bytes > 0


def test_full_equals_extrapolate():
    over = dict(n_layers=10, dtype="bfloat16", param_dtype="bfloat16")
    recs = {m: dr.run_cell("olmo-tiny", "decode_32k", False, verbose=False,
                           method=m, cfg_overrides=over, device_type="cpu")
            for m in ("full", "extrapolate")}
    assert [r["status"] for r in recs.values()] == ["ok", "ok"], recs
    full, ext = (recs[m]["roofline"] for m in ("full", "extrapolate"))
    for k in ("flops_per_dev", "bytes_per_dev", "coll_bytes_per_dev"):
        assert full[k] == ext[k], k
    assert recs["full"]["collectives"] == recs["extrapolate"]["collectives"]
    assert recs["full"]["memory_analysis"] == \
        recs["extrapolate"]["memory_analysis"]
    assert not dist.is_initialized()


def test_c10d_functional_and_p2p_collectives_are_counted():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.distributed.collectives import hierarchical_psum
    with dr.fake_world(8):
        mesh = make_test_mesh(2, 2, pods=2, device_type="cpu")
        with FakeTensorMode():
            x = torch.empty(64, 32)
            d = distribute_tensor(torch.empty(64, 32), mesh,
                                  [Shard(0), Replicate(), Replicate()])
            with dr.StepCounter() as counter:
                hierarchical_psum(x, mesh)   # c10d, in place
                d.redistribute(mesh, [Replicate()] * 3)  # functional
                ops = [dist.P2POp(dist.isend, x, 1),
                       dist.P2POp(dist.irecv, torch.empty(64, 32), 1)]
                for w in dist.batch_isend_irecv(ops):
                    w.wait()
    ops = [r["op"] for r in counter.records]
    assert any(o.startswith("c10d.") for o in ops)
    assert any(o.startswith("_c10d_functional.") for o in ops)
    out = collective_bytes(counter.records)
    # the hierarchical psum: reduce-scatter of the whole block over data,
    # all-reduce of the half over pod, all-gather of the half over data
    assert out["reduce-scatter"] == 64 * 32 * 4
    assert out["all-reduce"] == 32 * 32 * 4
    # DTensor's gather of one 32-row shard over pod, plus the psum's
    assert out["all-gather"] == 32 * 32 * 4 + 32 * 32 * 4
    assert out["collective-permute"] == 64 * 32 * 4   # the send only
    assert out["total"] == sum(out[k] for k in KINDS)


def test_counter_skips_shape_propagation():
    """A DTensor product counts its local block's FLOPs once: not the
    global-shape product DTensor runs to propagate shapes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with dr.fake_world(512):
        from repro_torch.launch.mesh import make_production_mesh
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        with FakeTensorMode():
            a = distribute_tensor(torch.empty(4096, 4096), mesh,
                                  [Replicate(), Shard(0), Replicate()])
            b = distribute_tensor(torch.empty(4096, 4096), mesh,
                                  [Replicate(), Replicate(), Shard(1)])
            with dr.StepCounter() as counter:
                a @ b
    assert counter.flops == 2 * 256 * 4096 * 256


def test_cli_runs_a_tiny_config_on_the_cpu(tmp_path):
    out = tmp_path / "dryrun.jsonl"
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
         "cpu", "--arch", "olmo-tiny", "--shape", "train_4k",
         "--multi-pod", "single", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    rec = json.loads(out.read_text().splitlines()[-1])
    assert rec["status"] == "ok"
    for k in ("roofline", "collectives", "memory_analysis",
              "compile_seconds"):
        assert k in rec
    want_row = jrl.Roofline(arch="a", shape="s", mesh="m", flops_per_dev=1,
                            bytes_per_dev=1, coll_bytes_per_dev=1,
                            coll_breakdown={}, model_flops=1).row()
    assert list(rec["roofline"]) == list(want_row)
    assert list(rec["memory_analysis"]) == [
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes",
        "alias_size_in_bytes"]
    assert "dry-run complete: 1 ok" in proc.stdout


def test_skipped_cell_is_recorded():
    rec = dr.run_cell("qwen3-14b", "long_500k", False, verbose=False,
                      device_type="cpu")
    assert rec["status"] == "skipped" and "full-attention" in rec["reason"]


def test_imports_set_up_no_process_group():
    code = ("import torch.distributed as dist\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.hillclimb\n"
            "import repro_torch.launch.specs, repro_torch.analysis.roofline\n"
            "assert not dist.is_initialized()\nprint('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code],
                          env=dict(os.environ, PYTHONPATH=SRC),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr


def test_sharded_backward_runs_on_the_calling_thread(monkeypatch):
    """A CUDA backward (remat's recompute in it) would run on the autograd
    engine's device thread, where the thread-local sharding rules and
    DTensor's implicit replication are off: on a mesh the train step takes
    its gradient with the engine's threads disabled; on one device not."""
    seen = []
    grad = torch.autograd.grad

    def recording(*args, **kwargs):
        seen.append(torch._C._is_multithreading_enabled())
        return grad(*args, **kwargs)
    monkeypatch.setattr(torch.autograd, "grad", recording)
    cfg = dataclasses.replace(get_config("olmo-1b", tiny=True), remat="full")
    rules = single_pod_rules(fsdp=True)
    dr._compile_cell(cfg, "train_4k", None, rules, device_type="cpu")
    with dr.fake_world(4):
        mesh = make_test_mesh(2, 2, device_type="cpu")
        dr._compile_cell(cfg, "train_4k", mesh, rules, device_type="cpu")
    assert seen == [True, False]
    assert torch._C._is_multithreading_enabled()
