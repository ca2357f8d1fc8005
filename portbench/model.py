"""A configuration's architecture, and its weights made from the seed.

A configuration names its architecture with ``"model"``:
``architecture(cfg)`` is the module ``archs/<model>.py``, which gives the
shapes, the weights' blocks, the engine, its counters and its work
counts.

The weights are drawn block by block on the device, in the blocks the
architecture lists (for a decoder: the embedding, each layer, and the
final norm with the LM head).  Each block comes from one ``randn`` call
of a generator seeded from ``(seed, block)``, so the reference can make
one layer again without holding the model, and the program and the
reference are handed the same numbers.
"""

from __future__ import annotations

import hashlib
import importlib
import math
from types import ModuleType
from typing import Dict, Iterator, Tuple

import torch


def architecture(cfg: Dict) -> ModuleType:
    """The configuration's architecture module, ``archs/<model>.py``."""
    if "model" not in cfg:
        raise ValueError(f"configuration {cfg.get('name')!r} names no "
                         f"architecture: it needs \"model\", the name of a "
                         f"module in portbench/archs/")
    return importlib.import_module(f"portbench.archs.{cfg['model']}")


def block_seed(seed: int, block: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}:{block}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def block_weights(arch: ModuleType, s, seed: int, block: str, device
                  ) -> Dict[str, torch.Tensor]:
    """One block's tensors (``arch.block_spec``), views of one f32 buffer
    drawn on ``device``."""
    spec = arch.block_spec(s, block)
    total = sum(math.prod(shape) for _, shape, _ in spec)
    gen = torch.Generator(device=device).manual_seed(block_seed(seed, block))
    buf = torch.randn(total, generator=gen, device=device,
                      dtype=torch.float32)
    out, off = {}, 0
    for name, shape, scale in spec:
        n = math.prod(shape)
        t = buf[off:off + n].view(shape)
        off += n
        if scale is None:
            t.mul_(0.1).add_(1.0)
        else:
            t.mul_(scale)
        out[name] = t
    return out


class SeededWeights:
    """The whole model's weights as the engine takes them (``items()``),
    drawn one block at a time as they are iterated: an engine that copies
    each tensor into its own store (paged residency) never holds more
    than one block of them on the device."""

    def __init__(self, arch: ModuleType, s, seed: int, device):
        self.arch, self.shapes = arch, s
        self.seed, self.device = seed, device

    def items(self) -> Iterator[Tuple[str, torch.Tensor]]:
        for block in self.arch.block_names(self.shapes):
            yield from block_weights(self.arch, self.shapes, self.seed,
                                     block, self.device).items()
