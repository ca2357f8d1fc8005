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
"""

from __future__ import annotations

import dataclasses
import math
import os
import threading
from typing import Dict, Iterable, List, Optional

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


class WeightPager:
    """Bounded device working set over a cold weight store.

    Eviction policies:
      "clock" — second-chance (DB buffer-manager default).
      "pin"   — MRU eviction: survivors stay pinned, the remainder streams
                through the victim slot.  Optimal for the cyclic per-layer
                scan of LLM decoding (CLOCK/LRU thrash to 0% hit rate on a
                cycle larger than the budget; MRU retains budget/cycle of
                it — the paper's disk+mem reuse regime).

    ``device`` holds the hot set: the CUDA card unless the caller passes
    ``"cpu"``; without CUDA a CUDA device raises.

    ``tracer`` (an optional ``repro_torch.obs.trace.TraceRecorder``)
    records a ``pager_fetch:{name}`` span for each miss and a
    ``pager_prefetch:{name}`` span for each prefetched entry (``cat=
    "pager"``, ``depth=1``, ``bytes=`` the cold entry's size), through
    ``add_span``, which is safe from the prefetch thread.  As in the
    reference, where the span covers an asynchronous ``device_put``, a
    span covers issuing the copy on the pager's stream (and staging a
    memmap through pinned memory), not the copy itself: the stream that
    reads the table waits on the copy's event, and that wait is charged to
    the step that reads it.
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

    def _traced_fetch(self, span: str, cold):
        """``_fetch`` under a ``cat="pager"`` span when a tracer is set."""
        if self.tracer is None:
            return self._fetch(cold)
        t0 = self.tracer._now_us()
        out = self._fetch(cold)
        self.tracer.add_span(span, cat="pager", ts_us=t0,
                             dur_us=self.tracer._now_us() - t0, depth=1,
                             bytes=_nbytes(cold))
        return out

    def _use(self, arr: torch.Tensor, ready) -> torch.Tensor:
        """Order the calling thread's stream after the entry's copy and
        keep the entry's bytes from reuse until that stream has read
        them."""
        if self._cuda:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            arr.record_stream(stream)
        return arr

    def _evict_until(self, need: int) -> None:
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
            # evict — remove by index and shift the hand with the list, so
            # the scan resumes at the element that followed the victim
            idx = self._clock.index(key)
            arr = self._hot.pop(key)
            self._ready.pop(key, None)
            self._held -= _nbytes(arr)
            self._clock.pop(idx)
            self._ref.pop(key, None)
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

    def get(self, name: str) -> torch.Tensor:
        """Fetch a weight into the hot set (device), paging as needed."""
        with self._lock:
            if name in self._hot:
                self._ref[name] = True
                self.stats.hits += 1
                if self.metrics is not None:
                    self.metrics.counter("pager_hits_total",
                                         "hot-set hits").inc()
                return self._use(self._hot[name], self._ready[name])
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
                arr, ready = self._traced_fetch(f"pager_fetch:{name}", cold)
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
            return self._use(arr, ready)

    def get_many(self, names: Iterable[str]) -> Dict[str, torch.Tensor]:
        return {n: self.get(n) for n in names}

    def prefetch(self, names: Iterable[str]) -> threading.Thread:
        """Async cold→device copy of upcoming tables (double buffering).

        Prefetched bytes are accounted against ``budget_bytes`` exactly
        like hot-set residents (they ARE on device): the thread evicts
        before each entry is published, and an entry that still cannot fit
        is dropped rather than silently blowing the budget — the later
        ``get`` then takes the ordinary miss path.
        """
        with self._lock:
            names = [n for n in names if n not in self._hot
                     and n not in self._prefetched and n in self._cold]

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
                arr, ready = self._traced_fetch(f"pager_prefetch:{n}", cold)
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
                    self._prefetched[n] = (arr, ready)
                    self._held += nb
                    self.stats.peak_bytes = max(self.stats.peak_bytes,
                                                self._held)
                    self.stats.bytes_loaded += _nbytes(cold)
                    if self.metrics is not None:
                        self.metrics.counter(
                            "pager_bytes_loaded_total",
                            "bytes moved cold→device").inc(_nbytes(cold))
                        self.metrics.gauge(
                            "pager_held_bytes",
                            "device hot-set bytes").set(self._held)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        return t

    @property
    def held_bytes(self) -> int:
        return self._held

    def total_cold_bytes(self) -> int:
        return sum(_nbytes(a) for a in self._cold.values())
