"""Every model family's loss and gradients on a 2×2 mesh equal one
device's, on the CPU.

The dry-run runs each family's train step on DTensor leaves; the model
code it needs (the MLA attention core and the SSD scan per shard, the
causal conv per shard, the dense MoE's replicated dispatch, the residual
layouts, the cached cross-attention's output projection) must give the
one-device values and gradients, with each per-shard gradient summed
where ranks computed parts of it.  One ``gloo`` group of 4 processes
(``python -c WORKER``, a free port, ``OMP_NUM_THREADS=1``, a 300 s limit)
runs each family's TINY config in f32 with ``remat="none"``, FSDP rules
(``single_pod_rules(fsdp=True)``), once on plain tensors and once on
DTensor leaves placed by ``param_pspecs`` and the batch by
``batch_pspec``, and compares loss and gradients: within 1e-5 of the
largest gradient of each leaf (f32 sums in another order).
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300
TOL = 1e-5
FAMILIES = ["mamba2-2.7b", "hymba-1.5b", "deepseek-v3-671b", "olmoe-1b-7b",
            "llama-3.2-vision-90b", "whisper-small"]

WORKER = r"""
import dataclasses, datetime, json, sys
import torch
import torch.distributed as dist

rank, world, port = (int(a) for a in sys.argv[1:4])
archs = sys.argv[4].split(",")
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=120))
from torch.distributed.tensor import DTensor, distribute_tensor
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed.sharding import (distribute_tree, placements,
                                              sharding_rules,
                                              single_pod_rules)
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import transformer as tf
from repro_torch.training.train_loop import batch_pspec, loss_fn, param_pspecs

mesh = make_test_mesh(2, 2, device_type="cpu")
rules = single_pod_rules(fsdp=True)
results = {}


def grads(params, batch, cfg):
    live = [p.detach().requires_grad_(True) for p in tf.tree_leaves(params)]
    loss, _ = loss_fn(tf.tree_unflatten(params, live), batch, cfg)
    g = torch.autograd.grad(loss, live, allow_unused=True,
                            materialize_grads=True)
    whole = [t.full_tensor() if isinstance(t, DTensor) else t for t in g]
    loss = loss.full_tensor() if isinstance(loss, DTensor) else loss
    return float(loss), whole


for arch in archs:
    cfg = dataclasses.replace(get_config(arch, tiny=True), remat="none")
    params = tf.init_params(cfg, 0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLM(vocab=cfg.vocab, seq_len=16,
                         global_batch=4).batch_at(0).items()}
    gen = torch.Generator().manual_seed(1)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(4, cfg.n_frames, cfg.d_model,
                                      generator=gen)
    if cfg.family == "vlm":
        batch["images"] = torch.randn(4, cfg.n_image_tokens, cfg.d_model,
                                      generator=gen)
    loss1, g1 = grads(params, batch, cfg)
    with sharding_rules(mesh, rules):
        sp = distribute_tree(params, param_pspecs(params, mesh), mesh)
        bpl = placements(batch_pspec(), mesh)
        sb = {k: distribute_tensor(v, mesh, bpl) for k, v in batch.items()}
        loss2, g2 = grads(sp, sb, cfg)
    n_sharded = sum(any(p.is_shard() for p in t.placements)
                    for t in tf.tree_leaves(sp))
    rel = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
              for a, b in zip(g2, g1))
    results[arch] = {"loss": loss1, "loss_diff": abs(loss2 - loss1),
                     "grad_rel": rel, "sharded_leaves": n_sharded,
                     "leaves": len(g1)}
if rank == 0:
    print("RESULTS " + json.dumps(results))
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("families")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    port = _free_port()
    logs = [out / f"rank{r}.log" for r in range(4)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", WORKER, str(r), "4", str(port),
                 ",".join(FAMILIES)], env=env, stdout=f,
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
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not bad, (bad, logs[bad[0][0]].read_text()[-4000:])
    line = [l for l in logs[0].read_text().splitlines()
            if l.startswith("RESULTS ")]
    assert line, logs[0].read_text()[-3000:]
    return json.loads(line[-1][len("RESULTS "):])


@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_loss_and_grads_match_one_device(results, arch):
    r = results[arch]
    print(f"{arch}: loss {r['loss']:.6f}, |diff| {r['loss_diff']:.3e}, "
          f"gradients' max |diff| / leaf max {r['grad_rel']:.3e}, "
          f"{r['sharded_leaves']} of {r['leaves']} leaves sharded")
    assert r["sharded_leaves"] > 0
    assert r["loss_diff"] <= TOL * max(1.0, abs(r["loss"]))
    assert r["grad_rel"] <= TOL
