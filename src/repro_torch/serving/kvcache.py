"""Paged KV cache — the paper's KV-cache tables (§3.4) as fixed-size pages.

The paper stores cached keys/values as relational rows keyed by token
index; decode INSERTs the new row and joins against the table.  Physically
that is a *paged* layout: fixed-size pages (= chunk tables) indexed through
a per-sequence page table.  The join key (seq, token) → (page, slot) is the
address split ``token // page ↦ page_id, token % page ↦ slot`` — exactly
the paper's chunk-index projection.

Pages are pooled across sequences (no per-sequence max-length allocation).
The page table and lengths live on the host (the scheduler's view); the
pools are tensors on an explicit device.  The pool accessors
(``append``/``gather``/``kernel_views``) come with the paged-attention
kernel: ROADMAP.md next slice N1.

The prefix cache (``CacheSegment``/``PrefixCache`` and the segment
bindings of ``BatchedCacheTables``) is not ported yet: ROADMAP.md next
slice N2.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.chunked import resolve_device
from repro_torch.core.executor import DenseTable
from repro_torch.core.llama_graph import copy_cache_slot, empty_cache_tables


@dataclasses.dataclass
class PagedKVConfig:
    n_layers: int
    n_kv: int
    head_dim: int
    page_size: int = 64          # tokens per page (the chunk size)
    n_pages: int = 256           # pool size (all sequences, per layer)
    max_pages_per_seq: int = 64
    dtype: str = "float32"
    # physical in-page layout: "row_chunk" clusters a page by slot
    # (position-major, the seed); "head_major" clusters by KV head, so one
    # head's history within a page is contiguous.
    layout: str = "row_chunk"


class PagedKVCache:
    """Host-managed page tables + device-resident page pool.

    pool[layer]: k/v tensors [n_pages, page_size, n_kv, head_dim]
    (``layout="row_chunk"``) or [n_pages, n_kv, page_size, head_dim]
    (``layout="head_major"``) on ``device``.
    page_table: [max_seqs, max_pages_per_seq] int32 numpy (-1 = unmapped).
    """

    def __init__(self, cfg: PagedKVConfig, max_seqs: int, device="cuda"):
        if cfg.layout not in ("row_chunk", "head_major"):
            raise ValueError(f"unsupported KV page layout {cfg.layout!r}")
        self.cfg = cfg
        self.max_seqs = max_seqs
        self.device = resolve_device(device)
        dt = getattr(torch, cfg.dtype)
        if cfg.layout == "head_major":
            shape = (cfg.n_layers, cfg.n_pages, cfg.n_kv, cfg.page_size,
                     cfg.head_dim)
        else:
            shape = (cfg.n_layers, cfg.n_pages, cfg.page_size, cfg.n_kv,
                     cfg.head_dim)
        self.k_pool = torch.zeros(shape, dtype=dt, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=dt, device=self.device)
        self.page_table = np.full((max_seqs, cfg.max_pages_per_seq), -1,
                                  np.int32)
        self.seq_lens = np.zeros((max_seqs,), np.int32)
        self._free: List[int] = list(range(cfg.n_pages))[::-1]
        self._active: Dict[int, bool] = {}

    # -- page-table management (host side, per scheduler tick) -----------------

    def allocate_seq(self, seq_id: int) -> None:
        assert not self._active.get(seq_id, False)
        self._active[seq_id] = True
        self.page_table[seq_id, :] = -1
        self.seq_lens[seq_id] = 0

    def free_seq(self, seq_id: int) -> None:
        for p in self.page_table[seq_id]:
            if p >= 0:
                self._free.append(int(p))
        self.page_table[seq_id, :] = -1
        self.seq_lens[seq_id] = 0
        self._active[seq_id] = False

    def ensure_capacity(self, seq_id: int, new_len: int) -> None:
        """Map enough pages for ``new_len`` tokens (INSERT pre-allocation)."""
        need = -(-new_len // self.cfg.page_size)
        have = int((self.page_table[seq_id] >= 0).sum())
        if need > self.cfg.max_pages_per_seq:
            raise RuntimeError("sequence exceeds max_pages_per_seq")
        for i in range(have, need):
            if not self._free:
                raise RuntimeError("KV page pool exhausted (preemption "
                                   "required — scheduler handles this)")
            self.page_table[seq_id, i] = self._free.pop()

    def free_page_count(self) -> int:
        return len(self._free)


class BatchedCacheTables:
    """Seq-indexed views over the relational KV-cache *tables* for batched
    decode (the paper's §3.4 cache relations with a leading ``seq`` key).

    One device-resident pool per cache table holds ``max_seqs`` slots; the
    batched decode pipeline sees gathered ``(seq ∈ [B), …)`` table views
    (copies), runs ONE plan for the whole batch, and the rows it appended
    are scattered back into their slots.  Sequences join
    (``write_prefill``) and leave (``free``) without touching the other
    slots — and without any replanning, since the plan is keyed only by
    the batch size.  Slot writes are in place: nothing outside this object
    holds a reference to a pool tensor.

    The trailing key order is the cache layout (``layout``), matching the
    single-sequence prefill environments that fill the slots.
    """

    def __init__(self, spec, max_seqs: int, cache_len: int, chunk_size: int,
                 layout: str = "row_chunk", *, device):
        self.max_seqs = max_seqs
        self.cache_len = cache_len
        self.device = resolve_device(device)
        self.tables = empty_cache_tables(spec, cache_len,
                                         chunk_size=chunk_size,
                                         layout=layout, batch=max_seqs,
                                         device=self.device)
        self.positions = np.zeros(max_seqs, np.int32)
        # per-slot generation counters: bumped on every slot mutation that
        # does NOT go through a decode tick (prefill fill, free).  Cached
        # batch views (BatchedDecoder) key on these, so view invalidation
        # fires even when a freed slot is reused by a NEW sequence — same
        # slot id, same batch tuple, different contents.
        self.generations = np.zeros(max_seqs, np.int64)

    def _index(self, seq_ids) -> torch.Tensor:
        return torch.from_numpy(
            np.asarray(seq_ids, np.int64).reshape(-1)).to(self.device)

    def slot_generations(self, seq_ids) -> tuple:
        """Generation stamp of a batch of slots (view-cache key)."""
        return tuple(int(g) for g in
                     self.generations[np.asarray(seq_ids, np.int64)])

    def write_prefill(self, seq_id: int, env, length: int) -> None:
        """Copy a single-sequence session's cache tables into a slot —
        the WHOLE slot is overwritten, so slot reuse never depends on
        :meth:`free` having run.  Key orders are aligned by name."""
        copy_cache_slot(self.tables, seq_id, env)
        self.positions[seq_id] = length
        self.generations[seq_id] += 1

    def free(self, seq_id: int) -> None:
        """Release a slot: reset its position.  Stale rows are never read
        (gathers cover active slots only, reads beyond a sequence's
        position are causally masked, and ``write_prefill`` overwrites the
        whole slot on reuse), so the device tensors are left as they are."""
        self.positions[seq_id] = 0
        self.generations[seq_id] += 1

    def gather_views(self, seq_ids):
        """Batch views: {table: DenseTable keyed (seq ∈ [B), …)}, gathered
        copies of the slots.  Duplicate ids are allowed (batch-size-bucket
        padding): the padded rows compute redundantly and scatter back
        identical values."""
        ids = self._index(seq_ids)
        out = {}
        for name, pool in self.tables.items():
            cn = next(iter(pool.cols))
            out[name] = DenseTable(
                keys=(("seq", len(ids)),) + pool.keys[1:],
                cols={cn: pool.cols[cn][ids]},
                col_types=dict(pool.col_types))
        return out

    def scatter_rows(self, seq_ids, env, positions,
                     pos_key: str = "tp") -> None:
        """Write back only the rows a decode tick appended: one new row per
        sequence at ``(seq, positions[seq])``, at the pool's position axis.
        Duplicate ids (bucket padding) write identical values."""
        ids = self._index(seq_ids)
        pos = self._index(positions)
        b_idx = torch.arange(len(ids), device=self.device)
        for name, pool in self.tables.items():
            cn = next(iter(pool.cols))
            pax = pool.key_names.index(pos_key)  # seq is axis 0
            upd = env[name].cols[cn].to(pool.cols[cn].dtype)
            rows = upd.movedim(pax, 1)[b_idx, pos]
            pool.cols[cn].movedim(pax, 1)[ids, pos] = rows
