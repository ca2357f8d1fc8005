"""Checkpointing: atomic save/restore and async snapshots, in the
reference's on-disk format.

Layout: ``<dir>/step_<N>/`` holding one ``.npy`` per tree leaf (named by
its flattened path, ``/`` → ``__``) + ``manifest.json`` (each leaf's file,
shape and dtype, the step, the caller's extras such as the data-pipeline
cursor).  bfloat16 leaves are stored as their ``uint16`` bits with
``"dtype": "bfloat16"`` in the manifest.  Writes go to ``step_<N>.tmp``
then ``os.rename`` — a crashed save never corrupts the latest checkpoint.

Leaves are tensors.  Paths are built as the reference's ``jax.tree_util``
paths print: dict keys sorted, a tuple's items by index, a NamedTuple's
fields as ``.name`` — so a ``(params, AdamWState)`` tuple writes
``0/embed/…``, ``1/.step``, ``1/.m/…`` and ``1/.v/…``, and either package
restores the other's checkpoints.  Leaves are stored whole: a DTensor
leaf is gathered (``full_tensor()``) first, so a checkpoint saved from any
mesh is byte-equal to the unsharded one.  ``restore`` places the leaves on
the device it is given or, leaf by leaf, onto the ``(mesh, placements)`` of
a shardings tree (``distribute_tensor``): the elastic reshard.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.core.chunked import resolve_device


def _map_with_paths(fn: Callable, tree, prefix: Tuple[str, ...] = (),
                    is_leaf: Callable = lambda _: False):
    """``fn(path, leaf)`` over a tree of dicts, tuples, lists and
    NamedTuples, in JAX's flattening order; the same structure back."""
    if is_leaf(tree):
        return fn("/".join(prefix), tree)
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, tree[k], prefix + (str(k),), is_leaf)
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_paths(fn, getattr(tree, f),
                                            prefix + ("." + f,), is_leaf)
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_paths(fn, x, prefix + (str(i),), is_leaf)
                          for i, x in enumerate(tree))
    if tree is None:
        return None
    return fn("/".join(prefix), tree)


def _flatten_with_paths(tree, is_leaf: Callable = lambda _: False
                        ) -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    _map_with_paths(flat.__setitem__, tree, is_leaf=is_leaf)
    return flat


def _whole(leaf: torch.Tensor) -> torch.Tensor:
    """A leaf's whole value: a DTensor gathered on every rank."""
    leaf = leaf.detach()
    return leaf.full_tensor() if isinstance(leaf, DTensor) else leaf


def _in_group() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def _is_writer() -> bool:
    return not _in_group() or dist.get_rank() == 0


def _host_leaves(tree, copy: bool = False) -> Dict[str, torch.Tensor]:
    """{path: the leaf whole, on the host} on the writer; {} elsewhere.

    Runs in the caller's thread: gathering a DTensor leaf
    (``full_tensor()``) is a collective that every rank joins, in the
    order of its other collectives.  Only the writer keeps a host copy."""
    writer = _is_writer()
    host: Dict[str, torch.Tensor] = {}
    for key, leaf in _flatten_with_paths(tree).items():
        t = _whole(leaf)
        if writer:
            host[key] = t.to("cpu", copy=copy)
    return host


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(the array to store, the dtype name for the manifest)."""
    if t.dtype == torch.bfloat16:  # numpy has none: store the bits
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _write(final: str, step: int, host: Dict[str, torch.Tensor],
           extra: Optional[Dict]) -> None:
    """Host leaves to ``final`` via ``final.tmp`` and a rename; file
    I/O only, no collective."""
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for key, t in host.items():
        arr, dtype_name = _to_numpy(t)
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                   "dtype": dtype_name}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def _step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def save(ckpt_dir: str, step: int, tree, extra: Optional[Dict] = None
         ) -> str:
    """Atomic synchronous save. Returns the final checkpoint path.

    In a process group of several ranks every rank calls it (a DTensor
    leaf is gathered by all), rank 0 writes, and all return once the
    checkpoint is in place."""
    final = _step_path(ckpt_dir, step)
    host = _host_leaves(tree)
    if _is_writer():
        _write(final, step, host, extra)
    if _in_group():
        dist.barrier()
    return final


class AsyncCheckpointer:
    """Overlaps checkpoint writes with training (one in flight).

    ``save`` gathers and copies to the host in the caller's thread, so
    training can write into the device tensors (in place) right away and
    no collective runs off that thread; the writer's thread only does file
    I/O.  In a group of several ranks every rank calls ``save`` and
    ``wait`` at the same steps: ``wait`` joins the writer and then holds
    every rank at a barrier until the checkpoint is in place."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._thread: Optional[threading.Thread] = None
        self._pending: Optional[str] = None
        self.last_path: Optional[str] = None

    def save(self, step: int, tree, extra: Optional[Dict] = None) -> None:
        self.wait()
        final = _step_path(self.ckpt_dir, step)
        host = _host_leaves(tree, copy=True)
        self._pending = final
        if _is_writer():
            self._thread = threading.Thread(
                target=_write, args=(final, step, host, extra), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending is not None:
            if _in_group():
                dist.barrier()
            self.last_path, self._pending = self._pending, None


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _load(path: str, rec: Dict) -> torch.Tensor:
    arr = np.load(os.path.join(path, rec["file"]))
    if rec["dtype"] == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _is_sharding(x) -> bool:
    """A ``(mesh, placements)`` pair (``sharding.NamedSharding``)."""
    return (isinstance(x, tuple) and len(x) == 2
            and isinstance(x[0], DeviceMesh))


def restore(ckpt_dir: str, step: Optional[int], abstract_tree,
            shardings=None, device="cuda") -> Tuple[Any, Dict]:
    """Restore onto ``device``, or onto a mesh.

    ``abstract_tree`` fixes the tree's structure and dtypes (its leaves
    are tensors on any device, ``meta`` included); a leaf stored in
    another dtype is cast to its abstract leaf's.  ``shardings``, a tree
    of the same structure whose leaves are ``(mesh, placements)`` or None,
    places each leaf by ``distribute_tensor`` (on the mesh's device; every
    rank reads the file); a None leaf, or no tree, goes to ``device``.
    """
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = _step_path(ckpt_dir, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    placed = ({} if shardings is None
              else _flatten_with_paths(shardings, is_leaf=_is_sharding))

    def leaf(key, ab):
        t = _load(path, manifest["leaves"][key])
        sh = placed.get(key)
        if sh is None:
            return t.to(device=resolve_device(device), dtype=ab.dtype)
        mesh, pl = sh
        return distribute_tensor(t.to(device=mesh.device_type,
                                      dtype=ab.dtype), mesh, pl)
    return _map_with_paths(leaf, abstract_tree), manifest


def garbage_collect(ckpt_dir: str, keep: int = 3) -> None:
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(_step_path(ckpt_dir, s), ignore_errors=True)
