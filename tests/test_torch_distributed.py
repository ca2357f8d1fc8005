"""The port's distributed subsystem (``repro_torch.distributed``,
``repro_torch.launch.mesh``, the spec half of ``training/train_loop.py``,
``checkpoint.restore``'s shardings and ``moe_apply_ep_local``) against the
reference's, on the CPU.

- The spec trees: every family's ``param_pspecs`` tree equals the
  reference's ``PartitionSpec``s leaf for leaf, on the 2×2 FSDP and the
  2×2×2 multi-pod meshes, with and without ``rule_overrides``.  The
  reference runs in this process on ``jax.sharding.AbstractMesh``; the port
  on ``DeviceMesh``es over a one-process ``"fake"`` process group, torn
  down when the module ends.
- One JAX oracle subprocess (8 forced host devices) runs the reference's
  ``tests/test_distributed.py`` sections 1–5 on meshes it builds with
  ``AxisType.Auto`` axes (the reference's ``make_test_mesh`` gives explicit
  axes, on which its own fixture dies in section 1), plus the reference's
  ``moe_apply_ep_local`` on a 2×2 mesh, and writes its inputs and outputs
  as ``.npy``.
- One ``gloo`` spawn per mesh shape (4 ranks on 2×2, 8 on 2×2×2, 4 on the
  ``(4,)`` pipeline mesh) runs the port on the same inputs, carried across
  with ``tree_from_numpy``.

Tolerances: the f32 tiny config's sharded loss within 1e-5 of the JAX and
the port's one-device losses, its params after one step within 1e-5
except Adam's sign flips (at most 0.1 % of a leaf, each within 2·lr, as
``tests/test_torch_training.py`` allows); the bf16 variant's loss within
the reference's 5e-3; the elastic reshard exact and its checkpoint
byte-equal to an unsharded save; the pipeline and its gradients within
1e-5 of the dense loop; the hierarchical psum within 1e-5 of the plain
one; the int8 error-feedback mean and residual within 1e-6 of JAX's;
``moe_apply_ep_local`` within 1e-5 of the reference's ``shard_map`` path,
with capacity drops.
"""

import contextlib
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.training import train_loop as jtl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.registry import ASSIGNED  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch.mesh import (make_production_mesh,  # noqa: E402
                                     make_test_mesh)
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.training.optimizer import AdamW  # noqa: E402
from repro_torch.training.train_loop import (batch_pspec,  # noqa: E402
                                             make_train_step, param_pspecs)

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
TIMEOUT_S = 300   # each subprocess group: a hung rendezvous fails the test
LR = 1e-3
FAMILIES = ASSIGNED + ["llama3-8b"]
OVERRIDES = {"embedding": ("vocab", None), "w1": (None, "mlp"),
             "wq": ("embed_fsdp", None, None)}


# -- subprocess plumbing ------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_group(argvs, out_dir: Path, name: str):
    """Start one process per argv, wait for all within ``TIMEOUT_S``, and
    fail (killing the rest) if one fails or the time runs out."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    logs = [out_dir / f"{name}.{i}.log" for i in range(len(argvs))]
    procs = []
    for argv, log in zip(argvs, logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(argv, env=env, stdout=f,
                                          stderr=subprocess.STDOUT))
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(i, p.returncode) for i, p in enumerate(procs) if p.returncode]
    assert not bad, (bad, logs[bad[0][0]].read_text()[-4000:])
    return logs[0].read_text()


def _results(text: str):
    line = [l for l in text.splitlines() if l.startswith("RESULTS ")]
    assert line, text[-3000:]
    return json.loads(line[-1][len("RESULTS "):])


# -- the JAX oracle ----------------------------------------------------------

ORACLE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, shutil
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from jax.experimental.shard_map import shard_map

from repro.configs import get_config
from repro.data.pipeline import SyntheticLM
from repro.distributed.collectives import ef_int8_allreduce, hierarchical_psum
from repro.distributed.pipeline import pipeline_apply
from repro.distributed.sharding import (sharding_rules, single_pod_rules,
                                        multi_pod_rules)
from repro.models import moe as jmoe
from repro.models import transformer as tf
from repro.training.optimizer import AdamW
from repro.training.train_loop import make_train_step, param_pspecs
from repro.training import checkpoint as ckpt

out = sys.argv[1]
LR = float(sys.argv[2])
results = {}

def auto_mesh(shape, names):
    return jax.make_mesh(shape, names,
                         axis_types=(AxisType.Auto,) * len(shape))

def save_tree(name, tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    np.savez(os.path.join(out, name + ".npz"), **{
        "__".join(str(getattr(k, "key", k)) for k in path):
        np.asarray(jnp.asarray(v, jnp.float32)) for path, v in flat})

def put(name, a):
    np.save(os.path.join(out, name + ".npy"),
            np.asarray(jnp.asarray(a, jnp.float32)))

# ---- 1. train step: 2x2 fsdp mesh == one device (f32, and bf16) ------------
cfg = get_config("llama3-8b", tiny=True)
params = tf.init_params(cfg, jax.random.PRNGKey(0))
save_tree("params", params)
opt = AdamW(lr=LR, warmup_steps=1, total_steps=10)
data = SyntheticLM(vocab=cfg.vocab, seq_len=16, global_batch=8)
batch = {k: jnp.asarray(v) for k, v in data.batch_at(0).items()}
mesh = auto_mesh((2, 2), ("data", "model"))
mesh3 = auto_mesh((2, 2, 2), ("pod", "data", "model"))

def one_step(cfg, params, mesh=None, rules=None, bspec=None):
    step = make_train_step(cfg, opt)
    if mesh is None:
        return jax.jit(step)(params, opt.init(params), batch)
    with mesh, sharding_rules(mesh, rules):
        specs = param_pspecs(params, mesh)
        shd = jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s), specs)
        psh = jax.tree_util.tree_map(jax.device_put, params, shd)
        bsh = {k: jax.device_put(v, NamedSharding(mesh, bspec))
               for k, v in batch.items()}
        return jax.jit(step)(psh, opt.init(psh), bsh)

p1, _, m1 = one_step(cfg, params)
save_tree("p1", p1)
results["loss_single"] = float(m1["loss"])
p2, _, m2 = one_step(cfg, params, mesh, single_pod_rules(fsdp=True),
                     P("data"))
save_tree("p2", p2)
results["loss_2x2"] = float(m2["loss"])

cfg16 = dataclasses.replace(cfg, param_dtype="bfloat16", dtype="bfloat16")
params16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
_, _, m16 = one_step(cfg16, params16)
results["loss_single_bf16"] = float(m16["loss"])
_, _, m16m = one_step(cfg16, params16, mesh, single_pod_rules(fsdp=True),
                      P("data"))
results["loss_2x2_bf16"] = float(m16m["loss"])

# ---- 2. multi-pod mesh (2x2x2) ---------------------------------------------
p3, _, m3 = one_step(cfg, params, mesh3, multi_pod_rules(fsdp=True),
                     P(("pod", "data")))
save_tree("p3", p3)
results["loss_2x2x2"] = float(m3["loss"])

# ---- 3. elastic reshard: save on 2x2, restore on 2x2x2 ----------------------
ckpt_dir = os.path.join(out, "jax_ckpt")
ckpt.save(ckpt_dir, 1, p2)
abstract = jax.tree_util.tree_map(
    lambda l: jax.ShapeDtypeStruct(l.shape, l.dtype), params)
with mesh3, sharding_rules(mesh3, multi_pod_rules(fsdp=True)):
    specs3 = param_pspecs(abstract, mesh3)
    sh3 = jax.tree_util.tree_map(lambda s: NamedSharding(mesh3, s), specs3)
    restored, _ = ckpt.restore(ckpt_dir, 1, abstract, sh3)
d = jax.tree_util.tree_map(
    lambda a, b: float(np.max(np.abs(
        np.asarray(jax.device_get(a), np.float32)
        - np.asarray(jax.device_get(b), np.float32)))), p2, restored)
results["elastic_reshard_delta"] = max(jax.tree_util.tree_leaves(d))

# ---- 4. pipeline parallelism: 4 stages == dense ----------------------------
pmesh = auto_mesh((4,), ("pod",))
L, D = 8, 16
keys = jax.random.split(jax.random.PRNGKey(1), L)
blocks = {"w": jax.vmap(lambda k: jax.random.normal(k, (D, D)) * 0.1)(keys)}
x = jax.random.normal(jax.random.PRNGKey(2), (8, D))
put("pipe_w", blocks["w"])
put("pipe_x", x)

def block_fn(p, x):
    return jnp.tanh(x @ p["w"])

dense = x
for i in range(L):
    dense = block_fn({"w": blocks["w"][i]}, dense)
piped = pipeline_apply(block_fn, blocks, x, pmesh, stage_axis="pod",
                       n_micro=4)
put("pipe_dense", dense)
put("pipe_piped", piped)
results["pipeline_vs_dense"] = float(jnp.max(jnp.abs(dense - piped)))

# ---- 5. collectives: hierarchical psum + int8 EF all-reduce -----------------
xs = jax.random.normal(jax.random.PRNGKey(3), (8, 16))
put("hier_x", xs)
sm = lambda f: shard_map(f, mesh=mesh3, in_specs=P(None, "model"),
                         out_specs=P(None, "model"), check_rep=False)
a = sm(lambda x: hierarchical_psum(x, "pod", "data"))(xs)
b = sm(lambda x: jax.lax.psum(x, ("pod", "data")))(xs)
put("hier", a)
results["hier_psum_delta"] = float(jnp.max(jnp.abs(a - b)))

g = jax.random.normal(jax.random.PRNGKey(4), (4, 8)) * 0.1
put("ef_g", g)
mean_g, new_err = shard_map(
    lambda g, e: ef_int8_allreduce(g, e, ("data",)), mesh=mesh3,
    in_specs=(P(None, None), P(None, None)),
    out_specs=(P(None, None), P(None, None)), check_rep=False)(
        g, jnp.zeros((4, 8)))
put("ef_mean", mean_g)
put("ef_err", new_err)
results["ef_int8_error"] = float(jnp.max(jnp.abs(mean_g - g)))

# ---- EP MoE with local dispatch on a 2x2 mesh, capacity drops ---------------
mcfg = dataclasses.replace(get_config("olmoe-1b-7b", tiny=True),
                           moe_impl="ep_local", capacity_factor=0.5)
mp = jmoe.moe_init(jax.random.PRNGKey(5), mcfg)
mx = jax.random.normal(jax.random.PRNGKey(6), (8, 32, mcfg.d_model))
save_tree("moe_p", mp)
put("moe_x", mx)
with mesh, sharding_rules(mesh, single_pod_rules()):
    y_ep = jax.jit(lambda p, x: jmoe.moe_apply_ep_local(p, x, mcfg))(mp, mx)
put("moe_y", y_ep)
big = dataclasses.replace(mcfg, capacity_factor=64.0)
with mesh, sharding_rules(mesh, single_pod_rules()):
    y_all = jax.jit(lambda p, x: jmoe.moe_apply_ep_local(p, x, big))(mp, mx)
results["moe_drop_effect"] = float(jnp.max(jnp.abs(y_ep - y_all)))

print("RESULTS " + json.dumps(results))
"""


# -- the port, one gloo group per mesh shape ---------------------------------

WORKER = r"""
import datetime, json, os, sys, shutil
import numpy as np
import torch
import torch.distributed as dist

group, rank, world, port, jdir, out = sys.argv[1:7]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=120))

import dataclasses
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard, Replicate, distribute_tensor
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed import collectives as col
from repro_torch.distributed.pipeline import pipeline_apply
from repro_torch.distributed.sharding import (
    NamedSharding, P, distribute_tree, multi_pod_rules, placements,
    sharding_rules, single_pod_rules)
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train_loop import (batch_pspec, make_train_step,
                                             param_pspecs)

LR = 1e-3
results = {}

def load_tree(name):
    tree = {}
    with np.load(os.path.join(jdir, name + ".npz")) as z:
        for k in z.files:
            node = tree
            *head, last = k.split("__")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = z[k]
    return tf.tree_from_numpy(tree, device="cpu")

def npy(name):
    return torch.from_numpy(np.load(os.path.join(jdir, name + ".npy")))

def put(name, t):
    if rank == 0:
        np.save(os.path.join(out, name + ".npy"),
                t.detach().float().numpy())

def put_tree(name, tree):
    flat = {}
    def walk(t, pre):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, pre + [k])
        else:
            flat["__".join(pre)] = t.detach().float().numpy()
    walk(tree, [])
    if rank == 0:
        np.savez(os.path.join(out, name + ".npz"), **flat)

def whole(tree):
    return tf.tree_map(
        lambda t: t.full_tensor() if isinstance(t, DTensor) else t, tree)

cfg = get_config("llama3-8b", tiny=True)
params = load_tree("params")
opt = AdamW(lr=LR, warmup_steps=1, total_steps=10)
batch = {k: torch.from_numpy(v) for k, v in
         SyntheticLM(vocab=cfg.vocab, seq_len=16,
                     global_batch=8).batch_at(0).items()}

def sharded_step(cfg, params, mesh, rules):
    with sharding_rules(mesh, rules):
        specs = param_pspecs(params, mesh)
        psh = distribute_tree(params, specs, mesh)
        for t, s in zip(tf.tree_leaves(psh), tf.tree_leaves(specs)):
            assert isinstance(t, DTensor)
            assert tuple(t.placements) == placements(s, mesh)
        bsh = {k: distribute_tensor(v, mesh, placements(batch_pspec(), mesh))
               for k, v in batch.items()}
        return make_train_step(cfg, opt)(psh, opt.init(psh), bsh)

if group == "mesh2":
    mesh = make_test_mesh(2, 2, device_type="cpu")
    rules = single_pod_rules(fsdp=True)
    p2, s2, m2 = sharded_step(cfg, params, mesh, rules)
    results["loss_2x2"] = m2["loss"].full_tensor().item()
    results["moments_placed"] = all(
        tuple(m.placements) == tuple(p.placements)
        for m, p in zip(tf.tree_leaves(s2.m), tf.tree_leaves(p2)))
    whole2 = whole(p2)
    put_tree("p2", whole2)
    # elastic reshard, first half: save the sharded params, and the same
    # values unsharded
    ckpt.save(os.path.join(out, "ckpt_sharded"), 1, p2)
    ckpt.save(os.path.join(out, "ckpt_plain"), 1, whole2)
    # an async save of the sharded state while the next step runs on it
    # (in place): the writer thread overlaps the step's collectives
    ack = ckpt.AsyncCheckpointer(os.path.join(out, "ckpt_async"))
    ack.save(1, p2)
    with sharding_rules(mesh, rules):
        bsh = {k: distribute_tensor(v, mesh, placements(batch_pspec(), mesh))
               for k, v in batch.items()}
        _, _, m2b = make_train_step(cfg, opt)(p2, s2, bsh)
    ack.wait()
    results["async_path"] = os.path.relpath(ack.last_path, out)
    results["loss_2x2_second"] = m2b["loss"].full_tensor().item()

    cfg16 = dataclasses.replace(cfg, param_dtype="bfloat16",
                                dtype="bfloat16")
    p16 = tf.tree_map(lambda t: t.to(torch.bfloat16), params)
    _, _, m16 = sharded_step(cfg16, p16, mesh, rules)
    results["loss_2x2_bf16"] = m16["loss"].full_tensor().item()

    mcfg = dataclasses.replace(get_config("olmoe-1b-7b", tiny=True),
                               moe_impl="ep_local", capacity_factor=0.5)
    mp, mx = load_tree("moe_p"), npy("moe_x")
    with sharding_rules(mesh, single_pod_rules()):
        xd = distribute_tensor(mx, mesh, placements(P("data"), mesh))
        y = moe.moe_apply_ep_local(mp, xd, mcfg)
        results["moe_y_placements"] = [str(p) for p in y.placements]
        put("moe_y", y.full_tensor())

elif group == "mesh3":
    mesh3 = make_test_mesh(2, 2, pods=2, device_type="cpu")
    rules = multi_pod_rules(fsdp=True)
    p3, _, m3 = sharded_step(cfg, params, mesh3, rules)
    results["loss_2x2x2"] = m3["loss"].full_tensor().item()
    put_tree("p3", whole(p3))

    # elastic reshard, second half: restore the 2x2 save onto 2x2x2
    abstract = tf.tree_map(lambda t: torch.empty_like(t, device="meta"),
                           params)
    with sharding_rules(mesh3, rules):
        specs3 = param_pspecs(abstract, mesh3)
    shard3 = tf.tree_map(lambda s: NamedSharding(mesh3, placements(s, mesh3)),
                         specs3)
    restored, _ = ckpt.restore(os.path.join(out, "ckpt_sharded"), 1,
                               abstract, shard3)
    results["restored_placed"] = all(
        tuple(t.placements) == placements(s, mesh3)
        for t, s in zip(tf.tree_leaves(restored), tf.tree_leaves(specs3)))
    put_tree("restored", whole(restored))

    # hierarchical psum: in_specs P(None, "model")
    xs = npy("hier_x")
    spec = placements(P(None, "model"), mesh3)
    xl = distribute_tensor(xs, mesh3, spec).to_local()
    a = col.hierarchical_psum(xl, mesh3, "pod", "data")
    b = col._all_reduce(xl.clone(), mesh3, ("pod", "data"))
    put("hier", DTensor.from_local(a, mesh3, spec).full_tensor())
    put("hier_plain", DTensor.from_local(b, mesh3, spec).full_tensor())
    odd = col.hierarchical_psum(xl[:3], mesh3, "pod", "data")
    results["hier_fallback_delta"] = (odd - b[:3]).abs().max().item()

    # int8 error feedback over ("data",): replicated in and out
    g = npy("ef_g")
    mean_g, new_err = col.ef_int8_allreduce(
        g, col.init_error_state({"g": g})["g"], mesh3, ("data",))
    put("ef_mean", mean_g)
    put("ef_err", new_err)

elif group == "pipe":
    pmesh = init_device_mesh("cpu", (4,), mesh_dim_names=("pod",))
    w, x = npy("pipe_w"), npy("pipe_x")
    cot = torch.from_numpy(np.random.default_rng(7).standard_normal(
        tuple(x.shape)).astype(np.float32))

    def block_fn(p, x):
        return torch.tanh(x @ p["w"])

    wd = distribute_tensor(w, pmesh, [Shard(0)]).requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    piped = pipeline_apply(block_fn, {"w": wd}, xg, pmesh,
                           stage_axis="pod", n_micro=4)
    (piped * cot).sum().backward()
    put("pipe_piped", piped)
    put("pipe_gw", wd.grad.full_tensor())
    put("pipe_gx", xg.grad)
    results["pipe_gw_placements"] = [str(p) for p in wd.grad.placements]

    wp = w.clone().requires_grad_(True)
    xp = x.clone().requires_grad_(True)
    dense = xp
    for i in range(w.shape[0]):
        dense = block_fn({"w": wp[i]}, dense)
    (dense * cot).sum().backward()
    put("pipe_dense", dense)
    put("pipe_dense_gw", wp.grad)
    put("pipe_dense_gx", xp.grad)

dist.barrier()
if rank == 0:
    print("RESULTS " + json.dumps(results))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("dist")


@pytest.fixture(scope="module")
def jax_results(run_dir):
    jdir = run_dir / "jax"
    jdir.mkdir()
    text = _run_group([[sys.executable, "-c", ORACLE, str(jdir), str(LR)]],
                      run_dir, "oracle")
    return _results(text), jdir


def _spawn(group, world, run_dir, jdir):
    out = run_dir / "port"
    out.mkdir(exist_ok=True)
    port = _free_port()
    text = _run_group([[sys.executable, "-c", WORKER, group, str(r),
                        str(world), str(port), str(jdir), str(out)]
                       for r in range(world)], run_dir, group)
    return _results(text), out


@pytest.fixture(scope="module")
def mesh2(jax_results, run_dir):
    return _spawn("mesh2", 4, run_dir, jax_results[1])


@pytest.fixture(scope="module")
def mesh3(mesh2, jax_results, run_dir):
    # restores the checkpoint the 2x2 group saved
    return _spawn("mesh3", 8, run_dir, jax_results[1])


@pytest.fixture(scope="module")
def pipe(jax_results, run_dir):
    return _spawn("pipe", 4, run_dir, jax_results[1])


def _load_tree(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _single_port_step(jdir, cfg):
    """The port's one-device step from the oracle's params."""
    flat = _load_tree(jdir / "params.npz")
    tree = {}
    for k, v in flat.items():
        node = tree
        *head, last = k.split("__")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    params = tf.tree_from_numpy(tree, device="cpu")
    params = tf.tree_map(lambda t: t.to(getattr(torch, cfg.param_dtype)),
                         params)
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLM(vocab=cfg.vocab, seq_len=16,
                         global_batch=8).batch_at(0).items()}
    opt = AdamW(lr=LR, warmup_steps=1, total_steps=10)
    return make_train_step(cfg, opt)(params, opt.init(params), batch)


def _assert_step_params(got, want, lr=LR, tol=1e-5):
    """One AdamW step's params: within ``tol`` except for sign flips of
    near-zero gradients (at most 0.1 % of a leaf, each within 2·lr)."""
    for k in want:
        diff = np.abs(got[k] - want[k])
        flips = diff > tol
        assert flips.mean() <= 1e-3, (k, flips.sum(), diff.max())
        assert diff.max() <= 2 * lr * (1 + 1e-4) + tol, (k, diff.max())


# -- the spec trees (one process, a fake process group) -----------------------


@contextlib.contextmanager
def _fake_group(world: int):
    """A one-process ``"fake"`` process group of ``world`` ranks, destroyed
    on exit, so no later test sees a group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


MESHES = {"2x2": ((2, 2), ("data", "model"), "single"),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"), "multi")}


def _test_mesh(name):
    return make_test_mesh(*MESHES[name][0][-2:],
                          pods=MESHES[name][0][0] if name == "2x2x2" else 0,
                          device_type="cpu")


def _flat_specs(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_specs(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tuple(tree)}


@pytest.mark.parametrize("overrides", [None, OVERRIDES],
                         ids=["rules", "overrides"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_spec_trees_match_reference(arch, mesh_name, overrides):
    shape, names, kind = MESHES[mesh_name]
    jrules = (jsh.single_pod_rules if kind == "single"
              else jsh.multi_pod_rules)(fsdp=True)
    rules = (sh.single_pod_rules if kind == "single"
             else sh.multi_pod_rules)(fsdp=True)
    jmesh = AbstractMesh(shape, names)
    with jsh.sharding_rules(jmesh, jrules):
        want = jtl.param_pspecs(jtf.abstract_params(j_get_config(arch)),
                                jmesh, rule_overrides=overrides)
        want_batch = tuple(jtl.batch_pspec())
    want = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s)
            for path, s in jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}
    with _fake_group(8):
        mesh = _test_mesh(mesh_name)
        with sh.sharding_rules(mesh, rules):
            got = _flat_specs(param_pspecs(
                tf.abstract_params(get_config(arch)), mesh,
                rule_overrides=overrides))
            got_batch = tuple(batch_pspec())
    assert got_batch == want_batch
    assert got == want
    if arch in ("deepseek-v3-671b", "olmoe-1b-7b") and overrides is None:
        experts = {k: v for k, v in got.items()
                   if "moe" in k and k.rsplit("/", 1)[-1] in ("w1", "w3")
                   and "shared" not in k}
        assert experts and all(v[1] == "model" for v in experts.values())


def test_placements_and_mesh_shapes():
    with _fake_group(8):
        m3 = _test_mesh("2x2x2")
        _check_placements(m3)


def _check_placements(m3):
    assert m3.mesh_dim_names == ("pod", "data", "model")
    assert sh.placements(sh.P(("pod", "data"), None, "model"), m3) == (
        sh.Shard(0), sh.Shard(0), sh.Shard(2))
    assert sh.placements(sh.P(), m3) == (sh.Replicate(),) * 3
    assert sh.named_sharding(m3, None, "model") == sh.NamedSharding(
        m3, (sh.Replicate(), sh.Replicate(), sh.Shard(1)))
    with pytest.raises(ValueError):
        sh.placements(sh.P(("data", "pod")), m3)
    # without a mesh the annotations are no-ops
    x = torch.ones(4, 4)
    assert sh.shard(x, "batch", None) is x
    assert sh.logical_spec("batch") == sh.P()


def test_production_meshes_build_on_a_fake_group():
    """256- and 512-rank meshes of the reference's shapes, built over a
    one-process fake group (torn down after)."""
    for multi, world, shape in ((False, 256, (16, 16)),
                                (True, 512, (2, 16, 16))):
        with _fake_group(world):
            m = make_production_mesh(multi_pod=multi, device_type="cpu")
            assert m.shape == shape
            assert m.mesh_dim_names[-2:] == ("data", "model")
    assert not dist.is_initialized()


# -- the sharded train step ----------------------------------------------------


def test_sharded_step_matches_single_device(jax_results, mesh2, mesh3):
    jres, jdir = jax_results
    res2, out = mesh2
    res3, _ = mesh3
    cfg = get_config("llama3-8b", tiny=True)
    p1, _, m1 = _single_port_step(jdir, cfg)
    port_single = m1["loss"].item()
    print(f"f32 losses: JAX one device {jres['loss_single']!r}, port one "
          f"device {port_single!r}; JAX 2x2 {jres['loss_2x2']!r}, port 2x2 "
          f"{res2['loss_2x2']!r}; JAX 2x2x2 {jres['loss_2x2x2']!r}, port "
          f"2x2x2 {res3['loss_2x2x2']!r}")
    for key, got in (("loss_2x2", res2["loss_2x2"]),
                     ("loss_2x2x2", res3["loss_2x2x2"])):
        assert abs(got - jres["loss_single"]) < 1e-5, (key, got)
        assert abs(got - port_single) < 1e-5, (key, got)
        assert abs(got - jres[key]) < 1e-5, (key, got, jres[key])
    want = _load_tree(jdir / "p1.npz")
    for name in ("p2", "p3"):
        got = _load_tree(out / f"{name}.npz")
        _assert_step_params(got, want)
        diffs = np.concatenate([np.abs(got[k] - want[k]).ravel()
                                for k in want])
        print(f"{name} params after one step: max |Δ| {diffs.max()!r}, "
              f"{int((diffs > 1e-5).sum())} of {diffs.size} beyond 1e-5")
    assert res2["moments_placed"]


def test_bf16_sharded_step_within_reference_bound(jax_results, mesh2):
    jres, jdir = jax_results
    res2, _ = mesh2
    import dataclasses
    cfg16 = dataclasses.replace(get_config("llama3-8b", tiny=True),
                                param_dtype="bfloat16", dtype="bfloat16")
    _, _, m16 = _single_port_step(jdir, cfg16)
    got = res2["loss_2x2_bf16"]
    print(f"bf16 losses: JAX one device {jres['loss_single_bf16']!r}, port "
          f"one device {m16['loss'].item()!r}; JAX 2x2 "
          f"{jres['loss_2x2_bf16']!r}, port 2x2 {got!r}")
    assert abs(got - jres["loss_single_bf16"]) < 5e-3
    assert abs(got - m16["loss"].item()) < 5e-3
    assert abs(got - jres["loss_2x2_bf16"]) < 5e-3


def test_elastic_reshard_is_exact(jax_results, mesh2, mesh3):
    jres, _ = jax_results
    res3, out = mesh3
    assert jres["elastic_reshard_delta"] == 0.0
    assert res3["restored_placed"]
    want, got = _load_tree(out / "p2.npz"), _load_tree(out / "restored.npz")
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    sharded, plain = out / "ckpt_sharded" / "step_00000001", \
        out / "ckpt_plain" / "step_00000001"
    assert sorted(os.listdir(sharded)) == sorted(os.listdir(plain))
    for name in os.listdir(plain):
        assert (sharded / name).read_bytes() == (plain / name).read_bytes()


def test_async_checkpoint_during_a_step_is_byte_equal(mesh2):
    res, out = mesh2
    assert res["async_path"] == "ckpt_async/step_00000001"
    assert np.isfinite(res["loss_2x2_second"])
    saved, plain = out / res["async_path"], \
        out / "ckpt_plain" / "step_00000001"
    assert sorted(os.listdir(saved)) == sorted(os.listdir(plain))
    for name in os.listdir(plain):
        assert (saved / name).read_bytes() == (plain / name).read_bytes()


# -- pipeline, collectives, EP MoE ---------------------------------------------


def test_pipeline_matches_dense_and_its_gradient(jax_results, pipe):
    jres, jdir = jax_results
    res, out = pipe
    piped = np.load(out / "pipe_piped.npy")
    assert np.abs(piped - np.load(out / "pipe_dense.npy")).max() < 1e-5
    assert np.abs(piped - np.load(jdir / "pipe_dense.npy")).max() < 1e-5
    assert np.abs(piped - np.load(jdir / "pipe_piped.npy")).max() < 1e-5
    assert jres["pipeline_vs_dense"] < 1e-5
    for g in ("gw", "gx"):
        want = np.load(out / f"pipe_dense_{g}.npy")
        assert np.abs(np.load(out / f"pipe_{g}.npy") - want).max() < 1e-5
    assert res["pipe_gw_placements"] == ["S(0)"]


def test_hierarchical_psum_matches_plain(jax_results, mesh3):
    jres, jdir = jax_results
    res, out = mesh3
    a, b = np.load(out / "hier.npy"), np.load(out / "hier_plain.npy")
    assert np.abs(a - b).max() < 1e-5
    assert np.abs(a - np.load(jdir / "hier.npy")).max() < 1e-5
    assert np.abs(a - 4 * np.load(jdir / "hier_x.npy")).max() < 1e-5
    assert res["hier_fallback_delta"] < 1e-5
    assert jres["hier_psum_delta"] < 1e-5


def test_int8_error_feedback_matches_jax(jax_results, mesh3):
    jres, jdir = jax_results
    _, out = mesh3
    mean_g, err = np.load(out / "ef_mean.npy"), np.load(out / "ef_err.npy")
    g = np.load(jdir / "ef_g.npy")
    assert np.abs(mean_g - np.load(jdir / "ef_mean.npy")).max() < 1e-6
    assert np.abs(err - np.load(jdir / "ef_err.npy")).max() < 1e-6
    assert np.abs(mean_g - g).max() < 2e-3      # quantisation bounded
    assert np.abs(err).max() > 0                # residual carried
    assert jres["ef_int8_error"] < 2e-3


def test_moe_ep_local_matches_shard_map_with_drops(jax_results, mesh2):
    jres, jdir = jax_results
    res, out = mesh2
    got = np.load(out / "moe_y.npy")
    print(f"EP MoE: max |Δ| against JAX "
          f"{np.abs(got - np.load(jdir / 'moe_y.npy')).max()!r}, the drops "
          f"move y by {jres['moe_drop_effect']!r}")
    assert np.abs(got - np.load(jdir / "moe_y.npy")).max() < 1e-5
    assert jres["moe_drop_effect"] > 1e-3       # the capacity dropped pairs
    assert res["moe_y_placements"] == ["S(0)", "R"]
