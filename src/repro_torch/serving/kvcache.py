"""Paged KV cache — the paper's KV-cache tables (§3.4) as fixed-size pages.

The paper stores cached keys/values as relational rows keyed by token
index; decode INSERTs the new row and joins against the table.  Physically
that is a *paged* layout: fixed-size pages (= chunk tables) indexed through
a per-sequence page table.  The join key (seq, token) → (page, slot) is the
address split ``token // page ↦ page_id, token % page ↦ slot`` — exactly
the paper's chunk-index projection.

Pages are pooled across sequences (no per-sequence max-length allocation).
The page table and lengths live on the host (the scheduler's view); the
pools are tensors on an explicit device.  ``kernels.paged_attention``
consumes the slot-major pool order through :meth:`PagedKVCache.kernel_views`
(which transposes when the pool is stored ``head_major``) and the page
table and lengths through :meth:`PagedKVCache.batch_views`.  The
relational engine's decode reads its own cache tables
(:class:`BatchedCacheTables` slots): the executor hands each to the same
kernel as a pool of contiguous pages with an identity page table.

The prefix cache (:class:`PrefixCache`) interns the cache tables of
completed prefills as immutable, refcounted segments
(:class:`CacheSegment`) under a chained content hash of their token
blocks; a hit binds a slot of :class:`BatchedCacheTables` to a segment,
by a full copy or by a shared binding whose rows below the boundary are
spliced into every gathered batch view.  Nothing writes a segment's tensors: the pipeline's cache
append is out of place (``core/pipeline.py``), slot writes go to the
pool, and splices go to freshly gathered copies.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.chunked import resolve_device
from repro_torch.core.executor import DenseTable, permute_table_keys
from repro_torch.core.llama_graph import copy_cache_slot, empty_cache_tables

# token-count histogram buckets for the cached-prefix-length distribution
# (the registry's DEFAULT_BUCKETS are latency seconds — useless for tokens)
CACHED_TOKEN_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                        256.0, 512.0, 1024.0, 2048.0, 4096.0)


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

    # -- device-side append / gather -------------------------------------------

    def append(self, seq_id: int, layer_k: torch.Tensor,
               layer_v: torch.Tensor, pos: int) -> None:
        """Write one token's K/V (all layers) at absolute position ``pos``.

        layer_k/v: [n_layers, n_kv, head_dim].  The (page, slot) address is
        the chunk-key projection of ``pos``.  The pools are written in place
        (the reference rebinds them to functionally updated arrays)."""
        self.ensure_capacity(seq_id, pos + 1)
        page = int(self.page_table[seq_id, pos // self.cfg.page_size])
        slot = pos % self.cfg.page_size
        for pool, new in ((self.k_pool, layer_k), (self.v_pool, layer_v)):
            new = torch.as_tensor(new).to(device=self.device,
                                          dtype=pool.dtype)
            if self.cfg.layout == "head_major":
                pool[:, page, :, slot] = new
            else:
                pool[:, page, slot] = new
        self.seq_lens[seq_id] = max(int(self.seq_lens[seq_id]), pos + 1)

    def gather(self, seq_id: int, layer: int
               ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """Materialise a sequence's K/V [T, n_kv, dh] (reference path)."""
        T = int(self.seq_lens[seq_id])
        pages = torch.from_numpy(np.asarray(
            self.page_table[seq_id][: -(-T // self.cfg.page_size)],
            np.int64)).to(self.device)
        k, v = self.k_pool[layer, pages], self.v_pool[layer, pages]
        if self.cfg.layout == "head_major":  # [P, hk, slot, dh] -> slot-major
            k = k.transpose(1, 2)
            v = v.transpose(1, 2)
        k = k.reshape(-1, self.cfg.n_kv, self.cfg.head_dim)[:T]
        v = v.reshape(-1, self.cfg.n_kv, self.cfg.head_dim)[:T]
        return k, v, T

    def batch_views(self, seq_ids: List[int]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Page tables [B, max_pages] and lengths [B] of a decode batch on
        the pools' device (the kernel's inputs; int64, the port's index
        type — the kernel wrapper narrows them to int32)."""
        ids = np.asarray(seq_ids, np.int64)
        pt = torch.from_numpy(self.page_table[ids].astype(np.int64))
        lens = torch.from_numpy(self.seq_lens[ids].astype(np.int64))
        return pt.to(self.device), lens.to(self.device)

    def kernel_views(self, layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """This layer's K/V pools in the slot-major order
        ``[n_pages, page_size, n_kv, head_dim]`` that
        ``kernels.paged_attention`` unpacks positionally.  When the pool is
        stored ``head_major`` this is a transposed view (the kernel takes
        the pool's strides, so nothing is copied).  Kernel consumers go
        through this accessor rather than indexing ``k_pool`` directly,
        since the pool's physical layout is config-chosen."""
        k, v = self.k_pool[layer], self.v_pool[layer]
        if self.cfg.layout == "head_major":  # [P, hk, slot, d] -> slot-major
            k = k.transpose(1, 2)
            v = v.transpose(1, 2)
        return k, v


@dataclasses.dataclass
class CacheSegment:
    """An immutable, refcounted KV segment: the cache tables of a completed
    (single-sequence) prefill, valid for the token prefix ``tokens``.

    The tables are the session environment's ``k_cache_L*``/``v_cache_L*``
    relations, ``cache_len`` rows deep — rows ``[0, len(tokens))`` hold the
    prefix's K/V, rows beyond are stale and never read (causal masking).
    Nothing writes them: a sequence that extends past the shared boundary
    appends through ``run_pipeline``, which clones a cache table before it
    writes the new rows (copy-on-write on every append), and a shared
    binding's splice writes into a freshly gathered batch copy — so
    segments are bound with zero copies.
    """

    tokens: Tuple[int, ...]
    tables: Dict[str, DenseTable]
    nbytes: int
    refcount: int = 0
    last_use: int = 0

    def __hash__(self):  # identity: segments are interned by the cache
        return id(self)

    def __eq__(self, other):
        return self is other


class PrefixCacheStats:
    def __init__(self):
        self.hits = 0
        self.misses = 0
        self.insertions = 0
        self.evictions = 0
        self.cached_tokens = 0  # total tokens served from cache


class PrefixCache:
    """Content-hash prefix index over KV segments (the relational analogue
    of vLLM-style automatic prefix caching).

    Prompts are hashed in ``block``-token chunks with a *chained* block
    hash (``h_i = hash((h_{i-1}, block_i))``), so a digest at boundary
    ``b`` commits to the entire prefix ``tokens[:b]``, not just the last
    block.  ``lookup`` walks the query's block boundaries deepest-first
    and returns the longest indexed prefix — verified token-exact against
    the segment's stored tokens, so a (vanishingly unlikely) digest
    collision can never splice wrong K/V rows into a sequence.

    Segments are refcounted (share-mode bindings pin them) and evicted
    LRU among ``refcount == 0`` segments when the store exceeds
    ``budget_bytes`` (or ``max_segments``) — dead segments only, mirroring
    the pager's rule that pinned working-set entries never evict.
    """

    def __init__(self, block: int = 16, budget_bytes: Optional[int] = None,
                 max_segments: Optional[int] = 32, metrics=None):
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        self.block = int(block)
        self.budget_bytes = budget_bytes
        self.max_segments = max_segments
        self.metrics = metrics
        self.stats = PrefixCacheStats()
        # chained digest -> list of (segment, boundary); a segment of
        # length L is indexed at every block boundary b <= L
        self._index: Dict[int, List[Tuple[CacheSegment, int]]] = {}
        self._segments: List[CacheSegment] = []
        self._tick = 0  # LRU clock (monotonic use counter)

    # -- hashing ----------------------------------------------------------

    def _boundaries(self, tokens) -> List[Tuple[int, int]]:
        """(boundary, chained digest) at every full block of ``tokens``."""
        out = []
        h = 0
        for i in range(0, len(tokens) - len(tokens) % self.block,
                       self.block):
            h = hash((h,) + tuple(tokens[i:i + self.block]))
            out.append((i + self.block, h))
        return out

    # -- metrics ----------------------------------------------------------

    def _count(self, outcome: str) -> None:
        if self.metrics is not None:
            self.metrics.counter(
                f"serving_prefix_cache_{outcome}_total",
                f"prefix cache {outcome}").inc()

    def _export_gauges(self) -> None:
        if self.metrics is not None:
            self.metrics.gauge(
                "serving_prefix_cache_segments",
                "live KV segments in the prefix cache").set(
                    len(self._segments))
            self.metrics.gauge(
                "serving_prefix_cache_resident_bytes",
                "nominal bytes of live KV segments").set(
                    self.resident_bytes)

    @property
    def resident_bytes(self) -> int:
        return sum(s.nbytes for s in self._segments)

    # -- lookup / insert / refcounts --------------------------------------

    def lookup(self, tokens) -> Optional[Tuple[CacheSegment, int]]:
        """Longest cached prefix of ``tokens``, or None.

        The boundary is capped at ``len(tokens) - 1``: at least one prompt
        token must remain for the suffix prefill, whose final-position
        logits produce the sequence's first generated token.
        """
        tokens = list(tokens)
        for boundary, digest in reversed(self._boundaries(tokens)):
            if boundary >= len(tokens):
                continue
            for seg, b in self._index.get(digest, ()):
                if b == boundary and tuple(seg.tokens[:b]) == \
                        tuple(tokens[:b]):
                    self._tick += 1
                    seg.last_use = self._tick
                    self.stats.hits += 1
                    self.stats.cached_tokens += boundary
                    self._count("hits")
                    if self.metrics is not None:
                        self.metrics.histogram(
                            "serving_prefix_cached_tokens",
                            "tokens served from the prefix cache per hit",
                            buckets=CACHED_TOKEN_BUCKETS).observe(boundary)
                    return seg, boundary
        self.stats.misses += 1
        self._count("misses")
        return None

    def insert(self, tokens, env, nbytes: Optional[int] = None
               ) -> Optional[CacheSegment]:
        """Intern ``env``'s cache tables as a segment covering ``tokens``.

        Skipped when an already-indexed segment covers the deepest block
        boundary of ``tokens`` (inserting would add index weight without
        extending coverage).  The tables are shared by reference — O(1),
        no device copies (see :class:`CacheSegment` on why that is safe).
        """
        bounds = self._boundaries(tokens)
        if not bounds:
            return None
        deepest, digest = bounds[-1]
        for seg, b in self._index.get(digest, ()):
            if b == deepest and tuple(seg.tokens[:b]) == \
                    tuple(tokens[:b]):
                return None  # coverage already indexed
        tables = {nm: t for nm, t in env.items()
                  if nm.startswith(("k_cache_L", "v_cache_L"))}
        if nbytes is None:
            nbytes = sum(t.cols[c].numel() * t.cols[c].element_size()
                         for t in tables.values() for c in t.cols)
        self._tick += 1
        seg = CacheSegment(tokens=tuple(int(t) for t in tokens),
                           tables=tables, nbytes=int(nbytes),
                           last_use=self._tick)
        self._segments.append(seg)
        for boundary, digest in bounds:
            self._index.setdefault(digest, []).append((seg, boundary))
        self.stats.insertions += 1
        self._evict()
        self._export_gauges()
        return seg

    def acquire(self, seg: CacheSegment) -> None:
        seg.refcount += 1

    def release(self, seg: CacheSegment) -> None:
        assert seg.refcount > 0, "refcount underflow"
        seg.refcount -= 1
        # a just-released segment may unblock a pending eviction
        self._evict()
        self._export_gauges()

    # -- eviction ---------------------------------------------------------

    def _over_budget(self) -> bool:
        if self.max_segments is not None and \
                len(self._segments) > self.max_segments:
            return True
        return (self.budget_bytes is not None and
                self.resident_bytes > self.budget_bytes)

    def _evict(self) -> None:
        """Drop LRU dead (refcount-0) segments until within budget.  Live
        segments are pinned by their bindings and never evicted — the
        store may transiently exceed budget while every segment is live,
        exactly like pinned pages in the weight pager."""
        while self._over_budget():
            dead = [s for s in self._segments if s.refcount == 0]
            if not dead:
                return
            victim = min(dead, key=lambda s: s.last_use)
            self._segments.remove(victim)
            for entries in self._index.values():
                entries[:] = [(s, b) for s, b in entries if s is not victim]
            self.stats.evictions += 1
            self._count("evictions")
        self._export_gauges()


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
        # share-mode prefix bindings: seq_id -> (CacheSegment, boundary).
        # A bound slot's pool rows are authoritative only for positions
        # >= boundary; gather_views splices the segment's rows below it.
        # The slot never writes below the boundary (decode appends land at
        # the sequence's position, >= its full prompt length > boundary),
        # and the splice writes into the gathered copy, so the shared
        # segment tensors are never touched.
        self.bindings: Dict[int, Tuple[CacheSegment, int]] = {}

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
        self.release_binding(seq_id)
        copy_cache_slot(self.tables, seq_id, env)
        self.positions[seq_id] = length
        self.generations[seq_id] += 1

    def write_suffix(self, seq_id: int, env, length: int, boundary: int,
                     pos_key: str = "tp") -> None:
        """Share-mode slot fill: copy only rows ``[boundary, cache_len)``
        of a (suffix-prefilled) session's cache tables into the slot, in
        place — the relational ``INSERT ... SELECT ... WHERE tp >=
        boundary``.  Rows below the boundary stay whatever the slot last
        held; they are shadowed by the bound segment at gather time
        (:meth:`gather_views`), never read directly."""
        for nm, dst in self.tables.items():
            src = permute_table_keys(env[nm], dst.key_names[1:])
            cn = next(iter(dst.cols))
            pax = dst.key_names[1:].index(pos_key)
            slot = dst.cols[cn][seq_id].movedim(pax, 0)
            slot[boundary:] = src.cols[cn].movedim(pax, 0)[boundary:]
        self.positions[seq_id] = length
        self.generations[seq_id] += 1

    def bind_segment(self, seq_id: int, segment: CacheSegment,
                     boundary: int) -> None:
        """Record a share-mode binding (caller holds the segment's ref)."""
        self.bindings[seq_id] = (segment, boundary)
        self.generations[seq_id] += 1

    def release_binding(self, seq_id: int) -> Optional[CacheSegment]:
        """Drop a slot's binding, returning the segment (for the caller to
        unref) or None.  Idempotent; called on free AND on slot refill so
        reuse never inherits a stale splice."""
        bound = self.bindings.pop(seq_id, None)
        if bound is None:
            return None
        self.generations[seq_id] += 1
        return bound[0]

    def free(self, seq_id: int) -> None:
        """Release a slot: reset its position.  Stale rows are never read
        (gathers cover active slots only, reads beyond a sequence's
        position are causally masked, and ``write_prefill`` overwrites the
        whole slot on reuse), so the device tensors are left as they are.

        Callers owning prefix-cache refs (``BatchedDecoder.free``) must
        release the slot's binding through their own path first; any
        binding still present here is dropped without unref."""
        self.release_binding(seq_id)
        self.positions[seq_id] = 0
        self.generations[seq_id] += 1

    def gather_views(self, seq_ids, pos_key: str = "tp"):
        """Batch views: {table: DenseTable keyed (seq ∈ [B), …)}, gathered
        copies of the slots.  Duplicate ids are allowed (batch-size-bucket
        padding): the padded rows compute redundantly and scatter back
        identical values.

        Slots bound to a shared prefix segment (:meth:`bind_segment`) are
        composed here: the segment's rows ``[0, boundary)`` are written
        over the gathered slot at the position axis — the relational
        ``seq-view UNION segment rows re-keyed to this seq`` — into the
        freshly gathered batch copy, never into the pool or the segment.
        The decoder's generation-keyed view cache makes it a
        once-per-batch-change cost, not a per-tick one."""
        ids = self._index(seq_ids)
        bound = [(b, int(s)) for b, s in enumerate(np.asarray(
            seq_ids, np.int64).reshape(-1)) if int(s) in self.bindings]
        out = {}
        for name, pool in self.tables.items():
            cn = next(iter(pool.cols))
            arr = pool.cols[cn][ids]  # advanced indexing: a copy
            pax = pool.key_names.index(pos_key) - 1  # axis within a slot
            for b, sid in bound:
                seg, boundary = self.bindings[sid]
                src = permute_table_keys(seg.tables[name],
                                         pool.key_names[1:])
                arr[b].movedim(pax, 0)[:boundary] = \
                    src.cols[cn].movedim(pax, 0)[:boundary]
            out[name] = DenseTable(
                keys=(("seq", len(ids)),) + pool.keys[1:],
                cols={cn: arr},
                col_types=dict(pool.col_types))
        return out

    def scatter(self, seq_ids, env) -> None:
        """Write updated batch views back into their slots (full tables).

        Reference/bulk path (tests, state import) — the decode hot path
        uses :meth:`scatter_rows`, which writes back only the one row per
        sequence a tick appends."""
        ids = self._index(seq_ids)
        for name, pool in self.tables.items():
            cn = next(iter(pool.cols))
            pool.cols[cn][ids] = env[name].cols[cn].to(pool.cols[cn].dtype)
        # external slot mutation: cached views go stale
        self.generations[np.asarray(seq_ids, np.int64).reshape(-1)] += 1

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
