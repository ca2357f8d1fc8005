"""Multi-pod dry-run: run every (arch × shape × mesh) cell's step once on
fake tensors and count what each device does.

For each cell, on a ``"fake"`` process group of 256 or 512 ranks (one
process, no device memory):

    with sharding_rules(mesh, rules), FakeTensorMode():
        args = DTensor leaves placed as the reference's in_shardings
        with StepCounter() as counter:
            cell.step_fn(*args)            # eager, every layer
        counter.flops / .bytes / .records / memory_analysis

Meshes: 16×16 (single pod, 256 ranks) and 2×16×16 (two pods, 512 ranks).
Placements come from the logical-axis rules (DP over pod+data, TP/EP over
model, FSDP optional).  Results stream to a JSONL report with the
reference's record keys.

The counts are rank 0's local work, which is what the reference's
``cost_analysis()`` reports for its partitioned program, but counted
differently:

* FLOPs are those of the matmul, convolution and attention families
  (``torch.utils.flop_counter``'s formulas); XLA counts every HLO op.
* Bytes are each local op's inputs read and outputs written, views left
  out, with no fusion; XLA counts after fusion.
* Collectives are every c10d call, DTensor's functional ones and the
  in-place ones the port's own collectives make, with their operand bytes.
* Memory: the arguments' local bytes are exact; ``temp_size_in_bytes`` is
  the high-water mark of the storages the step allocated, less its new
  outputs; no code is generated.

The process group is set up in :func:`run_cell` (or by the caller), never
at import.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
        --shape decode_32k --multi-pod both --out build/dryrun.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
        --arch olmo-tiny --shape decode_32k   # a TINY config, this CPU
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis.roofline import (Roofline, collective_bytes,
                                           collective_kind, model_flops_for)
from repro_torch.configs import get_config
from repro_torch.configs.registry import ASSIGNED
from repro_torch.distributed.sharding import (P, logical_spec_for_shape,
                                              mesh_shape, multi_pod_rules,
                                              placements, sharding_rules,
                                              single_pod_rules)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import SHAPES, build_cell, cell_supported
from repro_torch.models import transformer as tf  # group_plan
from repro_torch.training.train_loop import param_pspecs

# ops that allocate without reading or writing a byte
_ALLOCATIONS = {"empty", "empty_strided", "empty_like", "new_empty",
                "new_empty_strided"}
_COLLECTIVE_NAMESPACES = {"c10d", "_c10d_functional"}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _operand_bytes(func, args) -> int:
    """Bytes this rank sends into a collective: the input of a functional
    collective (its first argument) or of an in-place c10d call (the
    second of the (output, input) gathers, scatters and all-to-alls, the
    first otherwise); a receive sends nothing."""
    name = func.overloadpacket.__name__
    if name.startswith(("recv", "irecv")):
        return 0
    if name == "batch_p2p_ops":  # (ops, peers, tags, tensors, group)
        return sum(_nbytes(t) for op, t in zip(args[0], args[3])
                   if op == "isend")
    second = func.namespace == "c10d" and any(
        s in name for s in ("gather", "scatter", "alltoall"))
    return sum(_nbytes(t) for t in _tensors(args[1 if second else 0]))


class StepCounter(TorchDispatchMode):
    """Counts one rank's work while a step runs under it: ``flops`` (the
    matmul, convolution and attention families), ``bytes`` (each op's
    tensor inputs and outputs, views, allocations and collectives left
    out), ``records`` (one ``{"op", "bytes"}`` a collective call, operand
    bytes) and ``peak_bytes`` (the high-water mark of the storages
    allocated under it).

    On DTensor arguments it declines the op (``NotImplemented``), so
    DTensor's dispatch runs and its local ops, each rank's own work, come
    back here; the global-shape ops DTensor runs on fake tensors to
    propagate shapes are not counted.  Works on real and fake tensors."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.records: List[Dict[str, Any]] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self.new_storages: Dict[int, Any] = {}
        self._shadow = 0
        self._patched = None

    # DTensor's shape propagation runs the op at global shapes on fake
    # tensors through this mode: those ops are not a rank's work
    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import (
            ShardingPropagator as SP)
        names = [n for n in ("_propagate_tensor_meta_non_cached",
                             "_propagate_tensor_meta") if hasattr(SP, n)]
        if not names:
            raise RuntimeError("DTensor's ShardingPropagator has no "
                               "_propagate_tensor_meta: the counter cannot "
                               "tell shape propagation from local work")
        orig = getattr(SP, names[0])

        def shadowed(prop, *a, **k):
            self._shadow += 1
            try:
                return orig(prop, *a, **k)
            finally:
                self._shadow -= 1
        setattr(SP, names[0], shadowed)
        self._patched = (SP, names[0], orig)
        return super().__enter__()

    def __exit__(self, *exc):
        cls, name, orig = self._patched
        setattr(cls, name, orig)
        return super().__exit__(*exc)

    def _freed(self, key: int, nbytes: int):
        def cb(_ref):
            self.live_bytes -= nbytes
            self.new_storages.pop(key, None)
        return cb

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        ins = _tensors((args, kwargs))
        out = func(*args, **kwargs)
        if self._shadow:
            return out
        name = func.overloadpacket.__name__
        outs = _tensors(out)
        if func.namespace in _COLLECTIVE_NAMESPACES:
            if collective_kind(name) is not None:
                self.records.append({"op": f"{func.namespace}.{name}",
                                     "bytes": _operand_bytes(func, args)})
        else:
            formula = flop_registry.get(func.overloadpacket)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
        # a view (any op whose outputs all alias its inputs without writing
        # them) and an allocation move no bytes
        seen = {id(t.untyped_storage()) for t in ins}
        aliases = all(id(t.untyped_storage()) in seen for t in outs)
        if (func.namespace not in _COLLECTIVE_NAMESPACES and outs
                and name not in _ALLOCATIONS
                and not (aliases and not func._schema.is_mutable)):
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in seen or key in self.new_storages:
                continue
            nbytes = st.nbytes()
            self.new_storages[key] = weakref.ref(st, self._freed(key,
                                                                 nbytes))
            self.live_bytes += nbytes
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return out


@dataclasses.dataclass
class MemoryAnalysis:
    """The fields of XLA's ``memory_analysis()`` the reference reports,
    for one rank's step (bytes)."""
    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: int
    generated_code_size_in_bytes: int
    alias_size_in_bytes: int


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def memory_analysis(counter: StepCounter, args, out) -> MemoryAnalysis:
    """The step's memory from its arguments, its outputs and the counter's
    high-water mark: arguments and outputs as their local shards, each
    storage once; an output in an argument's storage (a cache or parameter
    written in place) is aliased."""
    def storages(tree):
        got = {}
        for t in _tensors(tree):
            t = _local(t)
            got.setdefault(id(t.untyped_storage()), _nbytes(t))
        return got
    a, o = storages(args), storages(out)
    alias = sum(n for k, n in o.items() if k in a)
    new_out = sum(n for k, n in o.items() if k in counter.new_storages)
    return MemoryAnalysis(
        argument_size_in_bytes=sum(a.values()),
        output_size_in_bytes=sum(o.values()),
        temp_size_in_bytes=max(counter.peak_bytes - new_out, 0),
        generated_code_size_in_bytes=0, alias_size_in_bytes=alias)


def _map(fn, tree, *rest):
    """``fn(leaf, *rest_leaves)`` over the tensor leaves of nested dicts,
    tuples and NamedTuples (other leaves pass through); ``rest`` are trees
    of ``tree``'s structure whose leaves may be anything."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [_map(fn, *vs) for vs in zip(tree, *rest)]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    return fn(tree, *rest) if isinstance(tree, torch.Tensor) else tree


def _shardings_for(cell, mesh, cfg, rule_overrides=None):
    """Placement tree matching the cell's meta args."""
    def batch_dim_spec(leaf):
        return placements(logical_spec_for_shape(leaf.shape, "batch"), mesh)

    shape = mesh_shape(mesh)
    args = []
    for i, a in enumerate(cell.args):
        if i == 0:  # params
            specs = param_pspecs(a, mesh, rule_overrides=rule_overrides)
            args.append(tf.tree_map(lambda s: placements(s, mesh), specs))
        elif isinstance(a, dict) or not hasattr(a, "shape"):
            # batch dict: shard dim 0 over the batch axes.
            # cache trees: leaves are [L, B, S, ...] — prefer the batch dim;
            # when batch itself is too small (long-context, gb=1), fall back
            # to sequence parallelism over the KV length, then channels.
            def cache_spec(leaf):
                if leaf.ndim == 0:
                    return placements(P(), mesh)
                batch_axes = tuple(
                    a for a in (("pod", "data") if "pod" in shape
                                else ("data",)))
                ext = 1
                for ax in batch_axes:
                    ext *= shape[ax]
                spec = [None] * leaf.ndim
                logical = logical_spec_for_shape(leaf.shape, "batch")
                if tuple(logical) and tuple(logical)[0] is not None:
                    spec[0] = tuple(logical)[0]
                else:
                    # candidate dims: batch(1), seq(2), last
                    for dim in (1, 2, leaf.ndim - 1):
                        if 0 < dim < leaf.ndim and \
                                leaf.shape[dim] % ext == 0 \
                                and leaf.shape[dim] >= ext:
                            spec[dim] = batch_axes if len(batch_axes) > 1 \
                                else batch_axes[0]
                            break
                # optional: also shard the KV length dim over the model
                # axis (hillclimb C3 — sequence-parallel cache)
                kv_axes = KV_SEQ_RULE.get("axes")
                if kv_axes and leaf.ndim >= 3 and spec[2] is None:
                    kext = 1
                    for ax in kv_axes:
                        kext *= shape[ax]
                    if leaf.shape[2] % kext == 0 and leaf.shape[2] >= kext:
                        spec[2] = kv_axes if len(kv_axes) > 1 else kv_axes[0]
                return placements(P(*spec), mesh)
            args.append(_map(cache_spec, a))
        else:
            if a.ndim == 0:
                args.append(placements(P(), mesh))
            else:
                args.append(batch_dim_spec(a))
    return tuple(args)


def _fake_args(cell, shardings, mesh, device_type: str):
    """The cell's arguments as fake tensors on ``device_type`` (DTensor
    leaves on ``mesh`` placed by ``shardings``), inside the caller's
    ``FakeTensorMode``.  Decode's position is a host int, the cache's last
    row: the step reads it as an int, which a fake tensor cannot give."""
    def leaf(t, pl=None):  # a scalar (AdamW's step) stays a plain tensor
        fake = torch.empty(t.shape, dtype=t.dtype, device=device_type)
        return (fake if mesh is None or t.ndim == 0
                else distribute_tensor(fake, mesh, pl))

    args = (_map(leaf, cell.args) if mesh is None
            else _map(leaf, cell.args, shardings))
    if cell.kind == "decode":
        args = args[:-1] + (SHAPES[cell.shape_name]["seq_len"] - 1,)
    return args


def _moments_placed_as_params(train_step):
    """The train step on optimizer state placed by the cache rule (the
    reference's in_shardings): the port's AdamW updates each moment on its
    parameter's local shard, so the moments are first redistributed to
    their parameters' placements, as XLA reshards them inside the
    reference's step (the collectives are counted)."""
    def step(params, opt_state, batch):
        def placed(m, p):
            return m.redistribute(p.device_mesh, p.placements)
        opt_state = opt_state._replace(
            m=tf.tree_map(placed, opt_state.m, params),
            v=tf.tree_map(placed, opt_state.v, params))
        return train_step(params, opt_state, batch)
    return step


def _compile_cell(cfg, shape_name, mesh, rules, rule_overrides=None,
                  device_type: str = "cuda"):
    """Run one cell's step on fake tensors under the counters; return
    (memory analysis, metrics dict).  ``mesh=None`` runs it on one device,
    without DTensor."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with sharding_rules(mesh, rules):
        cell = build_cell(cfg, shape_name)
        in_sh = (_shardings_for(cell, mesh, cfg, rule_overrides)
                 if mesh is not None else None)
        with FakeTensorMode():
            args = _fake_args(cell, in_sh, mesh, device_type)
            step = cell.step_fn
            if cell.kind == "train" and mesh is not None:
                step = _moments_placed_as_params(step)
            with StepCounter() as counter:
                out = step(*args)
            mem = memory_analysis(counter, args, out)
    if cell.kind == "decode":  # the position: an int32 scalar in the spec
        mem.argument_size_in_bytes += 4
    coll = collective_bytes(counter.records)
    return mem, {
        "flops": float(counter.flops),
        "bytes": float(counter.bytes),
        "coll": {k: float(v) for k, v in coll.items()},
    }


def _big_group_layers(cfg, saturate: int) -> int:
    """The (single) distinct layer count of groups longer than ``saturate``.

    Every assigned arch has at most one distinct 'big' group length (e.g.
    deepseek: dense-prefix 3 ≤ saturate, MoE stack 58), which makes the
    two-point cost extrapolation exact.
    """
    bigs = {g.n_layers for g in tf.group_plan(cfg) if g.n_layers > saturate}
    if not bigs:
        return 0
    assert len(bigs) == 1, f"multiple big-group sizes {bigs} in {cfg.name}"
    return bigs.pop()


def _depth_reduced(cfg, k: int):
    """Config with the big layer group cut to ``k`` (per-layer structure
    unchanged, so each layer's counted cost is identical)."""
    over = {}
    if cfg.family == "moe" and cfg.first_dense_layers:
        over["n_layers"] = cfg.first_dense_layers + k
    elif cfg.family == "vlm":
        over["n_layers"] = cfg.cross_attn_every * k
    elif cfg.family == "encdec":
        over["n_layers"] = k
        over["n_enc_layers"] = k
    else:
        over["n_layers"] = k
    if cfg.global_attn_layers:
        # window size only changes mask values, never op shapes → cost-
        # neutral; drop the schedule so indices stay in range
        over["global_attn_layers"] = ()
    return dataclasses.replace(cfg, scan_unroll=10**6, **over)


KV_SEQ_RULE = {}  # set by hillclimb: e.g. {"axes": ("model",)}


@contextlib.contextmanager
def fake_world(size: int):
    """A one-process ``"fake"`` process group of ``size`` ranks for the
    meshes, destroyed on exit (a process holds one default group: a
    caller that has one runs the dry-run in a subprocess)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             fsdp: Optional[bool] = None, verbose: bool = True,
             extra_tag: str = "", method: str = "extrapolate",
             cfg_overrides: Optional[dict] = None,
             rule_overrides: Optional[dict] = None,
             rules_patch: Optional[dict] = None,
             device_type: str = "cuda") -> dict:
    """Run a cell's step under the counters and derive its roofline terms.

    method="full": one run of the whole depth.
    method="extrapolate": two reduced-depth runs (8 and 4 big-group
    layers) give the per-layer cost, (cost_A − cost_B)/(A − B), and the
    whole depth's by extrapolation; a third run at full depth gives the
    memory analysis.  Eager layers are identical ops, so the two methods
    agree exactly in FLOPs, bytes and collectives, except where the cache
    rule puts a stack's layers on the data ranks (a depth that the data
    axis divides): the step then gathers that stack whole, at full depth
    only.
    """
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    ok, reason = cell_supported(cfg, shape_name)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": reason}

    info = SHAPES[shape_name]
    n_chips = 512 if multi_pod else 256
    if fsdp is None:
        fsdp = info["kind"] == "train"  # weights+opt must shard to fit
    rules = (multi_pod_rules(fsdp=fsdp) if multi_pod
             else single_pod_rules(fsdp=fsdp))
    if rules_patch:
        rules.update(rules_patch)

    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": info["kind"], "fsdp": fsdp, "tag": extra_tag,
           "method": method}
    try:
        with fake_world(n_chips):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type=device_type)

            def count(c):
                return _compile_cell(c, shape_name, mesh, rules,
                                     rule_overrides, device_type)

            A, B = 8, 4
            if method == "full" or _big_group_layers(cfg, A) == 0:
                mem, m = count(cfg)
                flops, bytes_acc = m["flops"], m["bytes"]
                coll = m["coll"]
            else:
                L_big = _big_group_layers(cfg, A)
                _, mB = count(_depth_reduced(cfg, B))
                _, mA = count(_depth_reduced(cfg, A))
                mem, _ = count(cfg)

                def extrap(a, b):
                    per_layer = (a - b) / (A - B)
                    return a + (L_big - A) * per_layer

                flops = extrap(mA["flops"], mB["flops"])
                bytes_acc = extrap(mA["bytes"], mB["bytes"])
                coll = {k: extrap(mA["coll"].get(k, 0.0),
                                  mB["coll"].get(k, 0.0))
                        for k in set(mA["coll"]) | set(mB["coll"])}
        compile_s = time.time() - t0

        rl = Roofline(
            arch=arch, shape=shape_name, mesh=mesh_name,
            flops_per_dev=flops, bytes_per_dev=bytes_acc,
            coll_bytes_per_dev=float(coll.get("total", 0.0)),
            coll_breakdown={k: int(v) for k, v in coll.items()},
            model_flops=model_flops_for(cfg, info, n_chips, info["kind"]),
            compile_seconds=compile_s,
        )
        rec.update(status="ok", roofline=rl.row(),
                   collectives={k: v for k, v in coll.items() if v},
                   memory_analysis=_mem_dict(mem),
                   compile_seconds=compile_s)
        if verbose:
            print(f"[OK] {arch} × {shape_name} × {mesh_name} "
                  f"(host {compile_s:.1f}s)")
            print(f"     memory_analysis: {rec['memory_analysis']}")
            print(f"     cost: flops/dev={flops:.3e} bytes/dev={bytes_acc:.3e}"
                  f" coll/dev={coll['total']:.3e}")
            print(f"     roofline: comp={rl.t_compute:.3e}s "
                  f"mem={rl.t_memory:.3e}s coll={rl.t_collective:.3e}s "
                  f"→ {rl.bottleneck}-bound, MODEL/HLO={rl.useful_flops_ratio:.2f}")
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[FAIL] {arch} × {shape_name} × {mesh_name}: {e}")
    return rec


def _mem_dict(mem) -> dict:
    if mem is None:
        return {}
    out = {}
    for k in ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes",
              "alias_size_in_bytes"):
        v = getattr(mem, k, None)
        if v is not None:
            out[k] = int(v)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default all)")
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--fsdp", default=None, type=lambda s: s == "true")
    ap.add_argument("--method", default="extrapolate",
                    choices=["extrapolate", "full"])
    ap.add_argument("--out", default="build/dryrun.jsonl")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device the fake tensors and meshes name")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ASSIGNED
    shapes = [args.shape] if args.shape else list(SHAPES)
    pods = {"single": [False], "multi": [True],
            "both": [False, True]}[args.multi_pod]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    n_ok = n_skip = n_fail = 0
    with open(args.out, "a") as f:
        for arch in archs:
            for shape in shapes:
                for mp in pods:
                    rec = run_cell(arch, shape, mp, fsdp=args.fsdp,
                                   method=args.method,
                                   device_type=args.device)
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
                    n_ok += rec["status"] == "ok"
                    n_skip += rec["status"] == "skipped"
                    n_fail += rec["status"] == "error"
    print(f"\ndry-run complete: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_fail} failed → {args.out}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
