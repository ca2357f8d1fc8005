"""WeightPager — the paper's disk+mem hybrid execution on the card's memory
hierarchy.

The paper leans on DuckDB's buffer manager: weight tables live on disk and
page into RAM on demand, bounded by a memory cap.  The tiers here:

    cold — ``.npy`` files on disk read through ``np.load(mmap_mode="r")``
           (with ``disk_dir``: "the database file"), else host tensors, in
           pinned memory when the hot set is on a CUDA device
    hot  — the device working set, bounded by ``budget_bytes``, evicted by
           CLOCK or MRU

On a CUDA device every cold → hot copy runs on a side stream of the
pager's own: ``copy_(non_blocking=True)`` from the pinned cold tensor, or
from a pinned staging tensor the memmap is read into (a memmap cannot be
pinned).  The copy records an event.  The stream that reads a hot tensor
waits on that event, and the tensor gets ``record_stream`` for that
stream: an eviction only drops the pager's reference, so without it the
caching allocator could hand the bytes to the next fetch while a queued
kernel still reads them.

``prefetch(names)`` starts the copies of upcoming tables on a thread; the
thread records each entry's event before it publishes the entry, and the
``get`` that takes it waits on the event.  Prefetched bytes count against
the budget like hot ones (they are on the device).  Accounting (hits,
misses, bytes moved, peak held) is the reference's: ``budget_bytes``
bounds what the pager holds, not what the caching allocator reserves.

A caller that runs the same pass over the tables again and again (the
relational engine: every call Scans the same weight tables in the same
order) marks each pass with ``begin_pass()`` and ``end_pass()``.  Under
``"pin"`` the first marked pass whose tables exceed the budget fixes a
:class:`PassSchedule`; see :class:`WeightPager`.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import os
import threading
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.chunked import resolve_device


@dataclasses.dataclass
class PagerStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    bytes_loaded: int = 0
    peak_bytes: int = 0
    prefetch_hits: int = 0

    def reset(self):
        self.__init__()


def _nbytes(a) -> int:
    """Bytes of a numpy array or tensor (``dtype.itemsize`` in both)."""
    return math.prod(a.shape) * a.dtype.itemsize


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np_dtype)).dtype


def spread_resident(sizes: Sequence[int], budget: int) -> List[bool]:
    """Which tables of a pass (their bytes, in scan order) stay resident.

    As many bytes as fit beside the pass's largest table (``budget -
    max(sizes)``, so any streamed table fits beside them), chosen evenly
    along the pass by cumulative bytes: each table adds its share of the
    bytes still to place to a credit, and a table is pinned when the
    credit covers half of it and it fits.  What one walk along the pass
    leaves (the cap stops a pin the credit asked for) is spread the same
    way over the tables still streamed, until nothing more fits."""
    room = budget - max(sizes, default=0)
    keep = [False] * len(sizes)
    held = 0
    while room > held:
        frac = (room - held) / sum(s for s, k in zip(sizes, keep) if not k)
        credit, before = 0.0, held
        for i, size in enumerate(sizes):
            if keep[i]:
                continue
            credit += frac * size
            if 2 * credit >= size and held + size <= room:
                keep[i] = True
                held += size
                credit -= size
        if held == before:
            break
    return keep


@dataclasses.dataclass
class PassSchedule:
    """The "pin" schedule of one pass: the tables in scan order, which of
    them stay resident (``keep``), and the others (``streamed``, in pass
    order), whose copies are issued ahead of their Scans."""
    order: List[str]
    sizes: List[int]
    keep: frozenset
    streamed: List[str]
    pos: Dict[str, int]
    # for each position of the pass, the index in ``streamed`` of the first
    # streamed table after it (cyclic: the last wraps to the next pass)
    next_streamed: List[int]

    @classmethod
    def plan(cls, order: List[str], sizes: List[int], budget: int
             ) -> "PassSchedule":
        flags = spread_resident(sizes, budget)
        streamed = [n for n, flag in zip(order, flags) if not flag]
        # past the last streamed table, the first of the next pass
        nxt, j, left = [0] * len(order), 0, len(streamed)
        for i in reversed(range(len(order))):
            nxt[i] = j
            if not flags[i]:
                left -= 1
                j = left
        return cls(order=order, sizes=sizes,
                   keep=frozenset(n for n, flag in zip(order, flags)
                                  if flag),
                   streamed=streamed,
                   pos={n: i for i, n in enumerate(order)},
                   next_streamed=nxt)

    @property
    def resident_bytes(self) -> int:
        return sum(s for n, s in zip(self.order, self.sizes)
                   if n in self.keep)

    @property
    def streamed_bytes(self) -> int:
        return sum(self.sizes) - self.resident_bytes


class WeightPager:
    """Bounded device working set over a cold weight store.

    Eviction policies:
      "clock" — second-chance (DB buffer-manager default).
      "pin"   — MRU eviction: survivors stay pinned, the remainder streams
                through the victim slot.  Optimal for the cyclic per-layer
                scan of LLM decoding (CLOCK/LRU thrash to 0% hit rate on a
                cycle larger than the budget; MRU retains budget/cycle of
                it — the paper's disk+mem reuse regime).  MRU keeps the
                pass's prefix, so a call first runs through resident tables
                with nothing to copy, then waits on the link for the rest.
                Given the pass (``begin_pass``/``end_pass`` around each
                call), the first pass whose tables exceed the budget fixes
                a :class:`PassSchedule` instead: as many resident bytes as
                MRU keeps (the budget less the pass's largest table) spread
                evenly along the pass, and each streamed table's copy
                issued ahead of its Scan, in pass order and on the calling
                thread, into the budget the resident set leaves: at every
                ``get`` of a table of the pass and at ``end_pass`` (which
                starts the next pass's copies).  A copy issued ahead waits
                in the prefetch buffer, is never evicted, and counts as a
                prefetch hit when its Scan takes it; streamed tables leave
                the hot set oldest first, that is, in pass order.  A table
                outside the pass takes the miss path.  Without a pass, or
                while the pass fits the budget, "pin" is plain MRU.

    ``device`` holds the hot set: the CUDA card unless the caller passes
    ``"cpu"``; without CUDA a CUDA device raises.

    ``tracer`` (an optional ``repro_torch.obs.trace.TraceRecorder``)
    records a ``pager_fetch:{name}`` span for each miss and a
    ``pager_prefetch:{name}`` span for each prefetched entry (``cat=
    "pager"``, ``depth=1``, ``bytes=`` the cold entry's size), through
    ``add_span``, which is safe from the prefetch thread.  A miss's span
    covers the whole ``get``: the wait for the lock, the allocation, the
    evictions, issuing the copy on the pager's stream (and staging a
    memmap through pinned memory) and ordering the reader's stream after
    it; a prefetch's covers issuing its copy (a copy a schedule issues
    ahead records its span on the calling thread, inside the ``get`` or
    ``end_pass`` that issued it).  Neither covers the copy
    itself: the stream that reads the table waits on the copy's event on
    the card.  Hits and prefetch hits record no span (``stats`` counts
    them).
    """

    def __init__(self, budget_bytes: int, disk_dir: Optional[str] = None,
                 policy: str = "clock", metrics=None, tracer=None,
                 device="cuda"):
        self.budget = budget_bytes
        self.policy = policy
        self.disk_dir = disk_dir
        # optional repro_torch.obs.MetricsRegistry mirror of ``stats``
        # (``stats`` stays the source of truth)
        self.metrics = metrics
        # cold→device fetch spans stamped with the ambient TraceContext
        # (prefetch spans carry none: they serve requests not yet known)
        self.tracer = tracer
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._cold: Dict[str, object] = {}     # memmap or host tensor
        self._hot: Dict[str, torch.Tensor] = {}
        self._ready: Dict[str, Optional[torch.cuda.Event]] = {}
        self._ref: Dict[str, bool] = {}        # CLOCK reference bits
        self._clock: List[str] = []
        self._hand = 0
        self._held = 0
        self._prefetched: Dict[str, tuple] = {}  # name -> (tensor, event)
        self._lock = threading.Lock()
        self.stats = PagerStats()
        # the pass being recorded between begin_pass and end_pass (names
        # in first-Scan order), then the schedule it fixed
        self._pass: Optional[Dict[str, None]] = None
        self.schedule: Optional[PassSchedule] = None
        # under a schedule: the streamed tables in the hot set that may
        # leave it, oldest Scan first (name -> bytes), and the position in
        # the pass of the last get
        self._fifo: "collections.OrderedDict[str, int]" = \
            collections.OrderedDict()
        self._fifo_bytes = 0
        self._cursor = 0

    # -- cold-store management -------------------------------------------------

    def add(self, name: str, array, pad_to: Optional[int] = None) -> None:
        """Register a weight (numpy array or tensor, on any device).  With
        ``disk_dir``, spill it to a ``.npy`` file read back as a memmap
        (the disk tier); otherwise keep a host tensor (pinned for a CUDA
        hot set), filled table by table.  A host tensor the caller made
        already in that form is kept as it is, as the reference keeps a
        host array.

        ``pad_to`` zero-pads the trailing dimension to a multiple of the
        given chunk size so the stored bytes equal the *physical* chunked
        table (padding included) — the working-set accounting then matches
        what the executor actually holds for planner-chosen chunk sizes.
        """
        shape = tuple(array.shape)
        width = shape[-1]
        if pad_to and width % pad_to:
            shape = shape[:-1] + (width + pad_to - width % pad_to,)
        if self.disk_dir is not None:
            arr = (array.cpu().numpy() if isinstance(array, torch.Tensor)
                   else np.asarray(array))
            if shape != arr.shape:
                arr = np.pad(arr, [(0, 0)] * (arr.ndim - 1)
                             + [(0, shape[-1] - width)])
            os.makedirs(self.disk_dir, exist_ok=True)
            path = os.path.join(self.disk_dir,
                                name.replace("/", "__") + ".npy")
            np.save(path, arr)
            cold = np.load(path, mmap_mode="r")
        elif (isinstance(array, torch.Tensor) and array.device.type == "cpu"
              and shape == tuple(array.shape) and array.is_contiguous()
              and (not self._cuda or array.is_pinned())):
            cold = array
        else:
            dtype = (array.dtype if isinstance(array, torch.Tensor)
                     else _torch_dtype(np.asarray(array).dtype))
            cold = torch.empty(shape, dtype=dtype, pin_memory=self._cuda)
            if shape[-1] != width:
                cold[..., width:].zero_()
            if isinstance(array, torch.Tensor):
                cold[..., :width].copy_(array)
            else:
                cold.numpy()[..., :width] = array
        with self._lock:
            # the prefetch thread reads _cold under the lock
            self._cold[name] = cold

    def add_tree(self, tree, prefix: str = "") -> None:
        """Register every leaf of a nested dict of arrays or tensors under
        ``prefix`` + its ``/``-joined key path.  Keys are walked sorted at
        every level, as the reference's ``tree_flatten_with_path`` walks
        them, so the cold store fills and a reader that fetches in the same
        order evicts in the reference's order."""
        def walk(node, path):
            if isinstance(node, dict):
                for k in sorted(node):
                    walk(node[k], path + (str(k),))
            else:
                self.add(prefix + "/".join(path), node)
        walk(tree, ())

    def cold_tensor(self, name: str) -> torch.Tensor:
        """A cold entry as a host tensor (a memmap is read into one)."""
        cold = self._cold[name]
        if isinstance(cold, torch.Tensor):
            return cold
        return torch.from_numpy(np.array(cold))

    # -- hot-set management ------------------------------------------------------

    def _fetch(self, cold):
        """Copy a cold entry to the device: ``(hot tensor, ready event)``
        (no event on the CPU, where the copy is done on return)."""
        if not self._cuda:
            return (cold.clone() if isinstance(cold, torch.Tensor)
                    else torch.from_numpy(np.array(cold))), None
        src = cold
        if not isinstance(cold, torch.Tensor):
            # the caching host allocator keeps the staging tensor's block
            # until the copy out of it has run
            src = torch.empty(cold.shape, dtype=_torch_dtype(cold.dtype),
                              pin_memory=True)
            src.numpy()[...] = cold
        with torch.cuda.stream(self._stream):
            hot = torch.empty(src.shape, dtype=src.dtype, device=self.device)
            hot.copy_(src, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return hot, ready

    def _span(self, name: str, t0: float, cold) -> None:
        """A ``cat="pager"`` span from ``t0`` (the tracer's µs) to now."""
        self.tracer.add_span(name, cat="pager", ts_us=t0,
                             dur_us=self.tracer._now_us() - t0, depth=1,
                             bytes=_nbytes(cold))

    def _use(self, arr: torch.Tensor, ready) -> torch.Tensor:
        """Order the calling thread's stream after the entry's copy and
        keep the entry's bytes from reuse until that stream has read
        them."""
        if self._cuda:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            arr.record_stream(stream)
        return arr

    def _evict(self, key: str) -> None:
        """Drop a hot entry — remove it by index and shift the hand with
        the list, so the scan resumes at the element that followed the
        victim."""
        idx = self._clock.index(key)
        arr = self._hot.pop(key)
        self._ready.pop(key, None)
        self._held -= _nbytes(arr)
        self._clock.pop(idx)
        self._ref.pop(key, None)
        if key in self._fifo:
            self._fifo_bytes -= self._fifo.pop(key)
        if idx < self._hand:
            self._hand -= 1
        if self._clock:
            self._hand %= len(self._clock)
        else:
            self._hand = 0
        self.stats.evictions += 1
        if self.metrics is not None:
            self.metrics.counter("pager_evictions_total",
                                 "hot-set evictions").inc()

    def _evict_until(self, need: int) -> None:
        # under a schedule the streamed tables leave first, in pass order
        while self._held + need > self.budget and self._fifo:
            self._evict(next(iter(self._fifo)))
        guard = 0
        while self._held + need > self.budget and self._clock:
            guard += 1
            if guard > 4 * len(self._clock) + 8:
                break  # single tensor larger than budget: allow overflow
            if self.policy == "pin":
                key = self._clock[-1]  # MRU: evict the newest arrival
            else:  # CLOCK (second-chance)
                self._hand %= len(self._clock)
                key = self._clock[self._hand]
                if self._ref.get(key, False):
                    self._ref[key] = False
                    self._hand += 1
                    continue
            self._evict(key)

    def get(self, name: str) -> torch.Tensor:
        """Fetch a weight into the hot set (device), paging as needed."""
        t0 = self.tracer._now_us() if self.tracer is not None else 0.0
        cold = None
        with self._lock:
            if self._pass is not None:
                self._pass[name] = None
            if name in self._hot:
                self._ref[name] = True
                self.stats.hits += 1
                if self.metrics is not None:
                    self.metrics.counter("pager_hits_total",
                                         "hot-set hits").inc()
                arr = self._use(self._hot[name], self._ready[name])
                if self.schedule is not None:
                    self._scanned(name, _nbytes(arr))
                return arr
            if name in self._prefetched:
                # the prefetch thread already accounted these bytes against
                # the budget (and evicted to make room) — moving the tensor
                # from the prefetch buffer to the hot set changes ownership,
                # not residency, so _held stays put
                arr, ready = self._prefetched.pop(name)
                self.stats.prefetch_hits += 1
                if self.metrics is not None:
                    self.metrics.counter("pager_prefetch_hits_total",
                                         "prefetched-page hits").inc()
            else:
                self.stats.misses += 1
                cold = self._cold[name]
                self.stats.bytes_loaded += _nbytes(cold)
                if self.metrics is not None:
                    self.metrics.counter("pager_misses_total",
                                         "cold-store page faults").inc()
                    self.metrics.counter(
                        "pager_bytes_loaded_total",
                        "bytes moved cold→device").inc(_nbytes(cold))
                arr, ready = self._fetch(cold)
                nb = _nbytes(arr)
                self._evict_until(nb)
                self._held += nb
            self._hot[name] = arr
            self._ready[name] = ready
            self._ref[name] = True
            self._clock.append(name)
            self.stats.peak_bytes = max(self.stats.peak_bytes, self._held)
            if self.metrics is not None:
                self.metrics.gauge("pager_held_bytes",
                                   "device hot-set bytes").set(self._held)
            out = self._use(arr, ready)
            if self.schedule is not None:
                self._scanned(name, _nbytes(arr))
        if cold is not None and self.tracer is not None:
            self._span(f"pager_fetch:{name}", t0, cold)
        return out

    # -- the pass schedule ("pin") --------------------------------------------

    def begin_pass(self) -> None:
        """Mark the start of a pass: under "pin", until a schedule is
        fixed, record the tables it Scans."""
        if self.policy == "pin" and self.schedule is None:
            with self._lock:
                self._pass = {}

    def end_pass(self) -> None:
        """Mark the end of a pass.  The first recorded pass whose tables
        exceed the budget fixes the schedule; under a schedule, issue the
        next pass's first copies, since no table of this one is read
        again."""
        if self.policy != "pin":
            return
        with self._lock:
            if self.schedule is not None:
                self._issue_ahead(self.schedule.next_streamed[self._cursor])
                return
            order, self._pass = list(self._pass or ()), None
            sizes = [_nbytes(self._cold[n]) for n in order]
            if sum(sizes) > self.budget:
                self._engage(PassSchedule.plan(order, sizes, self.budget))

    def _engage(self, sched: PassSchedule) -> None:
        """Fix ``sched``: every hot table it streams leaves, and the
        resident tables not hot yet are copied in (they are read next
        pass; they fit, by the plan, unless an entry prefetched outside
        the schedule holds their room: one that does not fit takes the
        miss path)."""
        self.schedule = sched
        for key in [k for k in self._clock if k not in sched.keep]:
            self._evict(key)
        for name, size in zip(sched.order, sched.sizes):
            if name in sched.keep and name not in self._hot \
                    and name not in self._prefetched \
                    and self._held + size <= self.budget:
                self._issue(name)
        self._cursor = len(sched.order) - 1
        self._issue_ahead(0)

    def _scanned(self, name: str, nbytes: int) -> None:
        """A get of ``name`` under a schedule: a streamed table joins the
        leaving queue at its end, and the copies that follow it are issued
        ahead."""
        sched = self.schedule
        if name not in sched.keep:
            if name in self._fifo:
                self._fifo.move_to_end(name)
            else:
                self._fifo[name] = nbytes
                self._fifo_bytes += nbytes
        pos = sched.pos.get(name)
        if pos is not None:
            self._cursor = pos
            self._issue_ahead(sched.next_streamed[pos])

    def _publish(self, name: str, arr: torch.Tensor, ready) -> None:
        """Put a copied entry into the prefetch buffer (under the lock):
        its bytes are held and loaded."""
        nb = _nbytes(arr)
        self._prefetched[name] = (arr, ready)
        self._held += nb
        self.stats.peak_bytes = max(self.stats.peak_bytes, self._held)
        self.stats.bytes_loaded += nb
        if self.metrics is not None:
            self.metrics.counter("pager_bytes_loaded_total",
                                 "bytes moved cold→device").inc(nb)
            self.metrics.gauge("pager_held_bytes",
                               "device hot-set bytes").set(self._held)

    def _issue(self, name: str) -> None:
        """Copy ``name`` into the prefetch buffer now, on this thread."""
        t0 = self.tracer._now_us() if self.tracer is not None else 0.0
        cold = self._cold[name]
        self._publish(name, *self._fetch(cold))
        if self.tracer is not None:
            self._span(f"pager_prefetch:{name}", t0, cold)

    def _issue_ahead(self, start: int) -> None:
        """Issue the copies of the streamed tables from ``start`` (an index
        in ``streamed``) on, in pass order, while they fit: streamed tables
        already read leave to make room, oldest first (as after a miss,
        the pager's reference goes; the reader's holds the bytes until its
        kernel has run).  One that is still hot is kept for its next
        Scan."""
        sched = self.schedule
        streamed, n = sched.streamed, len(sched.streamed)
        for k in range(n):
            name = streamed[(start + k) % n]
            if name in self._prefetched:
                continue
            pos = sched.pos[name]
            if name in self._hot:
                if pos == self._cursor:
                    break  # a whole pass ahead
                if name in self._fifo:
                    self._fifo_bytes -= self._fifo.pop(name)
                continue
            need = self._held + sched.sizes[pos] - self.budget
            if need > self._fifo_bytes:
                break
            while need > 0:
                victim = next(iter(self._fifo))
                need -= self._fifo[victim]
                self._evict(victim)
            self._issue(name)

    def get_many(self, names: Iterable[str]) -> Dict[str, torch.Tensor]:
        return {n: self.get(n) for n in names}

    def prefetch(self, names: Iterable[str]) -> threading.Thread:
        """Async cold→device copy of upcoming tables (double buffering).

        Prefetched bytes are accounted against ``budget_bytes`` exactly
        like hot-set residents (they ARE on device): the thread evicts
        before each entry is published, and an entry that still cannot fit
        is dropped rather than silently blowing the budget — the later
        ``get`` then takes the ordinary miss path.  Under a schedule the
        tables of its pass are left to the schedule.
        """
        with self._lock:
            owned = self.schedule.pos if self.schedule is not None else ()
            names = [n for n in names if n not in self._hot
                     and n not in self._prefetched and n in self._cold
                     and n not in owned]

        def run():
            for n in names:
                with self._lock:
                    # _cold is mutated by add() on other threads (e.g.
                    # layout/quant conversions registering tables) — never
                    # read it unlocked
                    cold = self._cold.get(n)
                if cold is None:
                    continue
                # the slow copy, outside the lock; its event is recorded
                # before the entry is published below
                t0 = self.tracer._now_us() if self.tracer is not None else 0.0
                arr, ready = self._fetch(cold)
                if self.tracer is not None:
                    self._span(f"pager_prefetch:{n}", t0, cold)
                nb = _nbytes(arr)
                with self._lock:
                    if n in self._hot or n in self._prefetched:
                        continue  # raced with a get(): already resident
                    self._evict_until(nb)
                    if self._held + nb > self.budget:
                        # nothing evictable is left (budget full of
                        # un-evictable prefetches or a huge tensor): drop
                        # this entry instead of overshooting the budget
                        continue
                    self._publish(n, arr, ready)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        return t

    @property
    def held_bytes(self) -> int:
        return self._held

    def total_cold_bytes(self) -> int:
        return sum(_nbytes(a) for a in self._cold.values())
