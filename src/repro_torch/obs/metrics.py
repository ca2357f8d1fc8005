"""Dependency-free in-process serving metrics.

A small registry of counters, gauges and histograms in the Prometheus
data model: series are keyed by ``(name, labels)``, histograms keep
cumulative bucket counts plus a bounded reservoir so the serving layer
can report quantiles (TTFT p50/p95, tick-latency p95) without any
external dependency.  Two exports:

* :meth:`MetricsRegistry.render_prometheus` — the text exposition
  format (``# TYPE``/``# HELP`` headers, ``_bucket``/``_sum``/``_count``
  histogram series) for scraping or eyeballing;
* :meth:`MetricsRegistry.to_dict` / :meth:`MetricsRegistry.save_json` —
  a JSON dump for build artifacts and offline comparison.

Instrumentation sites hold an ``Optional[MetricsRegistry]`` and guard
with ``if metrics is not None`` — disabled metrics cost one attribute
load and a branch, nothing else.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

# latency-oriented default bucket bounds (seconds)
DEFAULT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
_RESERVOIR = 4096

# what a /metrics endpoint serving render_prometheus() output should set
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
# ... and when serving render_openmetrics() output (exemplar-capable)
OPENMETRICS_CONTENT_TYPE = \
    "application/openmetrics-text; version=1.0.0; charset=utf-8"


class Counter:
    """Monotonically increasing counter.

    Mutation is lock-protected: the sharded serving path has N worker
    threads observing into shared series (``a += n`` is a read-modify-
    write, not atomic under concurrent writers)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.help = help
        self.labels = labels
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += n


class Gauge:
    """Settable instantaneous value (lock-protected mutation)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.help = help
        self.labels = labels
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self.value -= n


class Histogram:
    """Cumulative-bucket histogram with a bounded quantile reservoir.

    The bucket counts follow Prometheus semantics (``le`` upper bounds,
    ``+Inf`` implicit via ``count``); ``percentile`` interpolates over a
    ring buffer of the last ``_RESERVOIR`` observations, which is exact
    for the short runs this repo measures and bounded for long ones.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: Tuple[Tuple[str, str], ...] = (),
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.help = help
        self.labels = labels
        self.bounds = tuple(sorted(buckets or DEFAULT_BUCKETS))
        self.bucket_counts = [0] * len(self.bounds)
        self.count = 0
        self.sum = 0.0
        self._ring: List[float] = []
        self._ring_pos = 0
        # bucket index (len(bounds) = +Inf) -> (trace_id, value, unix ts):
        # the last exemplar observed into that bucket, for OpenMetrics
        # exposition — a bad p99 bucket links straight to its trace dump
        self.exemplars: Dict[int, Tuple[str, float, float]] = {}
        self._lock = threading.Lock()

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            for i, b in enumerate(self.bounds):
                if v <= b:
                    self.bucket_counts[i] += 1
            if exemplar is not None:
                idx = len(self.bounds)
                for i, b in enumerate(self.bounds):
                    if v <= b:
                        idx = i
                        break
                self.exemplars[idx] = (str(exemplar), v, time.time())
            if len(self._ring) < _RESERVOIR:
                self._ring.append(v)
            else:
                self._ring[self._ring_pos] = v
                self._ring_pos = (self._ring_pos + 1) % _RESERVOIR

    def merge(self, other: "Histogram") -> None:
        """Fold another histogram's observations into this one (per-shard
        registry merge).  Bucket bounds must match; the quantile ring
        absorbs the other's retained samples under the same reservoir
        bound."""
        if other.bounds != self.bounds:
            raise ValueError(
                f"histogram {self.name!r}: cannot merge bounds "
                f"{other.bounds} into {self.bounds}")
        with self._lock:
            self.count += other.count
            self.sum += other.sum
            for i, c in enumerate(other.bucket_counts):
                self.bucket_counts[i] += c
            self.exemplars.update(other.exemplars)
            for v in other._ring:
                if len(self._ring) < _RESERVOIR:
                    self._ring.append(v)
                else:
                    self._ring[self._ring_pos] = v
                    self._ring_pos = (self._ring_pos + 1) % _RESERVOIR

    def percentile(self, p: float) -> float:
        """p-th percentile (0..100) over the retained observations."""
        if not self._ring:
            return float("nan")
        xs = sorted(self._ring)
        if len(xs) == 1:
            return xs[0]
        rank = (p / 100.0) * (len(xs) - 1)
        lo = int(rank)
        hi = min(lo + 1, len(xs) - 1)
        frac = rank - lo
        return xs[lo] * (1 - frac) + xs[hi] * frac

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")


class MetricsRegistry:
    """Get-or-create registry of metric series.

    ``counter``/``gauge``/``histogram`` are idempotent per
    ``(name, labels)`` pair — instrumentation sites call them inline
    without caching handles.  Re-registering a name as a different
    metric kind is an error.
    """

    def __init__(self):
        self._series: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], object] = {}
        self._kinds: Dict[str, str] = {}
        self._helps: Dict[str, str] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, labels: Dict[str, str],
             **kwargs):
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            if name in self._kinds and self._kinds[name] != cls.kind:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{self._kinds[name]}, not {cls.kind}")
            m = self._series.get(key)
            if m is None:
                m = cls(name, help=help, labels=key[1], **kwargs)
                self._series[key] = m
                self._kinds[name] = cls.kind
                if help:
                    self._helps[name] = help
            return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None,
                  **labels) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def series(self) -> List[object]:
        with self._lock:
            return [self._series[k] for k in sorted(self._series)]

    def merge(self, child: "MetricsRegistry", **extra_labels) -> None:
        """Fold a child registry's series into this one, re-labelled.

        The sharded serving layer gives each worker a private registry
        (no cross-thread contention on the hot path) and merges them
        here at report time: counters add, gauges take the child's last
        value, histograms merge counts/sums/buckets/reservoir.
        ``extra_labels`` (e.g. ``shard="3"``) disambiguate the children;
        merging is additive, so merge each child once per report.
        """
        extra = {k: str(v) for k, v in extra_labels.items()}
        for m in child.series():
            labels = dict(m.labels)
            labels.update(extra)
            if m.kind == "counter":
                self.counter(m.name, m.help, **labels).inc(m.value)
            elif m.kind == "gauge":
                self.gauge(m.name, m.help, **labels).set(m.value)
            else:
                self.histogram(m.name, m.help, buckets=m.bounds,
                               **labels).merge(m)

    # -- exposition ----------------------------------------------------------

    @staticmethod
    def _label_str(labels: Tuple[Tuple[str, str], ...],
                   extra: str = "") -> str:
        parts = [f'{k}="{v}"' for k, v in labels]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    @staticmethod
    def _fmt(v: float) -> str:
        return repr(round(v, 9)) if isinstance(v, float) else str(v)

    def render_prometheus(self) -> str:
        """Prometheus text exposition format."""
        out: List[str] = []
        seen_header = set()
        for m in self.series():
            if m.name not in seen_header:
                seen_header.add(m.name)
                if self._helps.get(m.name):
                    out.append(f"# HELP {m.name} {self._helps[m.name]}")
                out.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Histogram):
                # bucket_counts are already cumulative per ``le`` bound
                for b, c in zip(m.bounds, m.bucket_counts):
                    le = f'le="{b}"'
                    out.append(f"{m.name}_bucket"
                               f"{self._label_str(m.labels, le)} {c}")
                inf = 'le="+Inf"'
                out.append(f"{m.name}_bucket"
                           f"{self._label_str(m.labels, inf)} {m.count}")
                out.append(f"{m.name}_sum{self._label_str(m.labels)}"
                           f" {self._fmt(m.sum)}")
                out.append(f"{m.name}_count{self._label_str(m.labels)}"
                           f" {m.count}")
            else:
                out.append(f"{m.name}{self._label_str(m.labels)}"
                           f" {self._fmt(m.value)}")
        return "\n".join(out) + ("\n" if out else "")

    def render_openmetrics(self) -> str:
        """OpenMetrics-flavoured exposition: the same series as
        :meth:`render_prometheus`, but histogram ``_bucket`` lines carry
        exemplar annotations (`` # {trace_id="..."} value timestamp``)
        when one was observed into that bucket, and the body terminates
        with ``# EOF``.  Series names are kept verbatim rather than
        re-suffixed, so both expositions stay join-compatible.
        """
        out: List[str] = []
        seen_header = set()
        for m in self.series():
            if m.name not in seen_header:
                seen_header.add(m.name)
                if self._helps.get(m.name):
                    out.append(f"# HELP {m.name} {self._helps[m.name]}")
                out.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Histogram):
                def _ex(idx: int) -> str:
                    ex = m.exemplars.get(idx)
                    if ex is None:
                        return ""
                    tid, v, ts = ex
                    return (f' # {{trace_id="{tid}"}} {self._fmt(v)}'
                            f" {self._fmt(ts)}")
                for i, (b, c) in enumerate(zip(m.bounds, m.bucket_counts)):
                    le = f'le="{b}"'
                    out.append(f"{m.name}_bucket"
                               f"{self._label_str(m.labels, le)} {c}"
                               f"{_ex(i)}")
                inf = 'le="+Inf"'
                out.append(f"{m.name}_bucket"
                           f"{self._label_str(m.labels, inf)} {m.count}"
                           f"{_ex(len(m.bounds))}")
                out.append(f"{m.name}_sum{self._label_str(m.labels)}"
                           f" {self._fmt(m.sum)}")
                out.append(f"{m.name}_count{self._label_str(m.labels)}"
                           f" {m.count}")
            else:
                out.append(f"{m.name}{self._label_str(m.labels)}"
                           f" {self._fmt(m.value)}")
        out.append("# EOF")
        return "\n".join(out) + "\n"

    def to_dict(self) -> Dict:
        """JSON-serialisable dump of every series."""
        dump: Dict[str, List[Dict]] = {}
        for m in self.series():
            entry: Dict = {"labels": dict(m.labels), "kind": m.kind}
            if isinstance(m, Histogram):
                entry.update(count=m.count, sum=m.sum,
                             buckets={str(b): c for b, c in
                                      zip(m.bounds, m.bucket_counts)})
                if m.count:
                    entry.update(p50=m.percentile(50),
                                 p95=m.percentile(95),
                                 p99=m.percentile(99))
            else:
                entry["value"] = m.value
            dump.setdefault(m.name, []).append(entry)
        return dump

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=str)
