"""Request-scoped trace context.

A ``TraceContext`` names the request(s) a piece of work is being done
for: the HTTP front end mints a ``trace_id`` at admission, the
scheduler carries it on the ``Request``, and every layer below —
engine plans, ``run_pipeline`` executor spans, shard workers, pager
fetches, DB statement traces, ``log_event`` records — picks the
ambient context up *implicitly* via a :mod:`contextvars` variable, so
none of those layers needs a new parameter to attribute its work to
the request(s) it served.

Two deliberate properties:

* **Batch-shaped.**  A batched decode tick serves every active request
  at once, so the context carries *tuples* of ids, not a single id.
  Prefill and admission contexts are just the single-element case.
* **Thread-locality is explicit.**  ``contextvars`` does **not**
  propagate into ``ThreadPoolExecutor`` workers — the shard pool
  captures ``current_context()`` on the coordinator thread and
  re-``activate``\\ s it inside each worker (see
  ``serving/shards.py``), and the pager's prefetch thread records
  spans context-free by design (prefetches serve future, unknown
  requests).

Dependency-free; importable from anywhere in the stack without
cycles.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import uuid
from typing import Dict, Iterator, Optional, Tuple

__all__ = [
    "TraceContext",
    "activate",
    "context_span_args",
    "current_context",
    "new_trace_id",
]


def new_trace_id() -> str:
    """Mint a fresh trace id (128-bit random, 16 hex chars — short
    enough to read in a log line, long enough to never collide within
    one server's flight-recorder window)."""
    return uuid.uuid4().hex[:16]


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """The set of requests the current work is attributed to.

    ``request_ids`` are the scheduler's integer rids (stable within one
    server process); ``trace_ids`` are the admission-minted hex ids
    (stable across log shipping / multi-process reconstruction).  The
    two tuples are parallel.  ``phase`` names the lifecycle stage
    (``admission`` / ``prefill`` / ``decode``), ``tick`` the scheduler
    tick when known.
    """

    request_ids: Tuple[int, ...] = ()
    trace_ids: Tuple[str, ...] = ()
    phase: str = ""
    tick: Optional[int] = None

    @classmethod
    def for_request(cls, rid: int, trace_id: str, phase: str = "",
                    tick: Optional[int] = None) -> "TraceContext":
        return cls(request_ids=(rid,), trace_ids=(trace_id,),
                   phase=phase, tick=tick)

    def span_args(self) -> Dict[str, object]:
        """The key/value payload attached to spans and log events
        recorded under this context: a new dict each call, whose id lists
        are built once per context and shared by every span it stamps (a
        batched tick stamps thousands; nothing mutates them)."""
        args: Dict[str, object] = {}
        if self.request_ids:
            args["rids"] = self._id_lists[0]
        if self.trace_ids:
            args["trace_ids"] = self._id_lists[1]
        if self.phase:
            args["phase"] = self.phase
        if self.tick is not None:
            args["tick"] = self.tick
        return args

    @functools.cached_property
    def _id_lists(self) -> Tuple[list, list]:
        return list(self.request_ids), list(self.trace_ids)


_CURRENT: contextvars.ContextVar[Optional[TraceContext]] = \
    contextvars.ContextVar("repro_trace_context", default=None)


def current_context() -> Optional[TraceContext]:
    """The active :class:`TraceContext`, or ``None`` outside any
    request scope (tests, offline planning, prefetch threads)."""
    return _CURRENT.get()


@contextlib.contextmanager
def activate(ctx: Optional[TraceContext]) -> Iterator[Optional[TraceContext]]:
    """Install ``ctx`` as the ambient context for the dynamic extent of
    the ``with`` block (``None`` deactivates — useful to scrub the
    context around work that serves no particular request)."""
    token = _CURRENT.set(ctx)
    try:
        yield ctx
    finally:
        _CURRENT.reset(token)


def context_span_args() -> Dict[str, object]:
    """``span_args()`` of the active context, or ``{}`` — the one-line
    hook :mod:`repro_torch.obs.trace` / :mod:`repro_torch.obs.log` call
    at record time."""
    ctx = _CURRENT.get()
    return ctx.span_args() if ctx is not None else {}
