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
restores the other's checkpoints.  Leaves are stored whole; ``restore``
places them on the device it is given.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.chunked import resolve_device


def _map_with_paths(fn: Callable, tree, prefix: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a tree of dicts, tuples, lists and
    NamedTuples, in JAX's flattening order; the same structure back."""
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, tree[k], prefix + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_paths(fn, getattr(tree, f),
                                            prefix + ("." + f,))
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_paths(fn, x, prefix + (str(i),))
                          for i, x in enumerate(tree))
    if tree is None:
        return None
    return fn("/".join(prefix), tree)


def _flatten_with_paths(tree) -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    _map_with_paths(flat.__setitem__, tree)
    return flat


def _to_numpy(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(the array to store, the dtype name for the manifest)."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:  # numpy has none: store the bits
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree, extra: Optional[Dict] = None
         ) -> str:
    """Atomic synchronous save. Returns the final checkpoint path."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    flat = _flatten_with_paths(tree)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for key, leaf in flat.items():
        arr, dtype_name = _to_numpy(leaf)
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                   "dtype": dtype_name}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


class AsyncCheckpointer:
    """Overlaps checkpoint writes with training (one in flight)."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None

    def save(self, step: int, tree, extra: Optional[Dict] = None) -> None:
        self.wait()
        # copy to the host *before* the thread starts, so training can
        # write into the device tensors (in place) right away
        host_tree = _map_with_paths(
            lambda _, l: l.detach().to("cpu", copy=True), tree)

        def run():
            self.last_path = save(self.ckpt_dir, step, host_tree, extra)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


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


def restore(ckpt_dir: str, step: Optional[int], abstract_tree,
            device="cuda") -> Tuple[Any, Dict]:
    """Restore onto ``device``.

    ``abstract_tree`` fixes the tree's structure and dtypes (its leaves
    are tensors on any device, ``meta`` included); a leaf stored in
    another dtype is cast to its abstract leaf's.
    """
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    device = resolve_device(device)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    def leaf(key, ab):
        return _load(path, manifest["leaves"][key]).to(device=device,
                                                       dtype=ab.dtype)
    return _map_with_paths(leaf, abstract_tree), manifest


def garbage_collect(ckpt_dir: str, keep: int = 3) -> None:
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
