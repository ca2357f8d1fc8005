"""Deterministic, shardable token pipeline with step-exact resume.

Every batch is a pure function of (seed, step, shard) — ``counter-mode``
data generation — so restart-after-failure reproduces the exact token
stream with no reader state beyond the step integer recorded in the
checkpoint manifest.  A file-backed source (token .bin memmap) layers the
same cursor discipline over real data.

A copy of the reference's (numpy only): batches are byte-equal to its.
Token ids stay ``int32``; the train step widens them where they index.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    """Zipfian synthetic LM stream: compressible structure so loss falls."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        per_shard = self.global_batch // self.n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard]))
        # Markov-ish stream: next token = prev token + zipf step (mod V)
        start = rng.integers(0, self.vocab, size=(per_shard, 1))
        steps = rng.zipf(1.5, size=(per_shard, self.seq_len)) % 17
        toks = (np.cumsum(np.concatenate([start, steps[:, :-1]], axis=1),
                          axis=1)) % self.vocab
        labels = np.concatenate(
            [toks[:, 1:], (toks[:, -1:] + steps[:, -1:]) % self.vocab],
            axis=1)
        return {"tokens": toks.astype(np.int32),
                "labels": labels.astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclasses.dataclass
class TokenFileSource:
    """Memmapped token binary (int32) with deterministic step cursor."""

    path: str
    vocab: int
    seq_len: int
    global_batch: int
    n_shards: int = 1
    shard: int = 0

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=np.int32, mode="r")

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        per_shard = self.global_batch // self.n_shards
        need = per_shard * (self.seq_len + 1)
        total = self._data.shape[0]
        offset = ((step * self.global_batch + self.shard * per_shard)
                  * (self.seq_len + 1)) % max(1, total - need)
        flat = np.asarray(self._data[offset: offset + need])
        flat = flat.reshape(per_shard, self.seq_len + 1) % self.vocab
        return {"tokens": flat[:, :-1].astype(np.int32),
                "labels": flat[:, 1:].astype(np.int32)}
