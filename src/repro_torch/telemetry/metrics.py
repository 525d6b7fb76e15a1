"""Metrics registry: counters, gauges, and log-bucketed latency histograms.

A copy of ``repro.telemetry.metrics`` (pure Python), kept so that the port
imports nothing of the JAX package.

One registry = one lock. Every instrument created by a registry shares
that single lock, which buys the property the ad-hoc ``stats`` dicts this
module replaces never had: a `snapshot()` (or any multi-counter `read`) is
POINT-IN-TIME ATOMIC. A reader can never observe a replica that counted a
batch but not its requests, or a ledger where the parts don't sum —
every invariant that holds under the lock holds in every snapshot.

Hot loops amortize the lock with one acquisition per event batch::

    with registry.lock:
        c_batches.value += 1
        c_requests.value += lanes
        h_wait.record_locked(wait_s)

while occasional updates just call the locked helpers (`Counter.add`,
`Histogram.record`, `Gauge.set`). Gauges may instead carry a zero-argument
callback that is invoked at snapshot time (queue depths, ring fill); the
callback runs UNDER the registry lock, so it must be cheap and must never
call back into this registry.

Histograms are log2-bucketed over ``[v0, v0 * 2**nbuckets)`` (defaults
span 100 ns .. ~20 min) — constant memory, O(1) record, and good-enough
p50/p95/p99: a percentile is the geometric midpoint of its bucket, so the
relative error is bounded by the bucket ratio (2x), clamped into the
exact observed [min, max]. Snapshots carry the raw bucket counts, so
histograms from different processes (actor hosts report theirs through
the result queue) merge exactly via `Histogram.merge_snapshots`.
"""

import math
import threading
from typing import Callable, Dict, List, Optional, Sequence

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


class Counter:
    """Accumulator (int or float). `add` takes the registry lock; batched
    hot paths mutate `.value` directly inside a ``with registry.lock``."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self.value = 0.0
        self._lock = lock

    def add(self, n=1):
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins value, or a callback read at snapshot time."""

    __slots__ = ("name", "value", "fn", "_lock")

    def __init__(self, name: str, lock: threading.Lock,
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.value = 0.0
        self.fn = fn
        self._lock = lock

    def set(self, v: float):
        with self._lock:
            self.value = float(v)

    def read_locked(self) -> float:
        if self.fn is not None:
            try:
                return float(self.fn())
            except Exception:
                return float("nan")   # a dead callback must not kill snapshot
        return self.value


class Histogram:
    """Log2-bucketed histogram (seconds-scale by default: v0=100 ns)."""

    __slots__ = ("name", "v0", "nbuckets", "counts", "count", "sum",
                 "min", "max", "_lock")

    def __init__(self, name: str, lock: threading.Lock, v0: float = 1e-7,
                 nbuckets: int = 44):
        self.name = name
        self.v0 = v0
        self.nbuckets = nbuckets
        self.counts = [0] * nbuckets
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = lock

    def _bucket(self, v: float) -> int:
        if v <= self.v0:
            return 0
        m, e = math.frexp(v / self.v0)          # v/v0 = m * 2**e, m in [.5, 1)
        return min(e - 1, self.nbuckets - 1)

    def record_locked(self, v: float):
        """Caller holds the registry lock (batched hot-path updates)."""
        v = float(v)
        self.counts[self._bucket(v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def record(self, v: float):
        with self._lock:
            self.record_locked(v)

    # ----------------------------------------------------------- snapshots

    def snapshot_locked(self) -> dict:
        buckets = {i: c for i, c in enumerate(self.counts) if c}
        out = {"count": self.count, "sum": self.sum, "v0": self.v0,
               "min": self.min if self.count else None,
               "max": self.max if self.count else None,
               "mean": (self.sum / self.count) if self.count else None,
               "buckets": buckets}
        out.update(self.percentiles_of(out))
        return out

    def snapshot(self) -> dict:
        with self._lock:
            return self.snapshot_locked()

    @staticmethod
    def percentiles_of(snap: dict, qs=(0.5, 0.95, 0.99)) -> dict:
        """p50/p95/p99 estimates from a bucketed snapshot: geometric
        midpoint of the covering bucket, clamped into the exact observed
        [min, max]. None when the histogram is empty (never raises)."""
        count = snap["count"]
        out = {f"p{int(q * 100)}": None for q in qs}
        if not count:
            return out
        v0 = snap["v0"]
        items = sorted(snap["buckets"].items())
        for q in qs:
            rank = q * count
            seen = 0
            val = None
            for i, c in items:
                seen += c
                if seen >= rank:
                    # bucket i covers [v0*2^i, v0*2^(i+1)): geometric mid
                    val = v0 * (2.0 ** i) * math.sqrt(2.0)
                    break
            val = min(max(val, snap["min"]), snap["max"])
            out[f"p{int(q * 100)}"] = val
        return out

    @staticmethod
    def merge_snapshots(snaps: Sequence[dict]) -> Optional[dict]:
        """Exact merge of bucketed snapshots (same v0) — how the parent
        combines its own wire-RTT histogram with each actor host's."""
        snaps = [s for s in snaps if s and s.get("count")]
        if not snaps:
            return None
        v0 = snaps[0]["v0"]
        buckets: Dict[int, int] = {}
        count, total = 0, 0.0
        lo, hi = math.inf, -math.inf
        for s in snaps:
            if s["v0"] != v0:
                raise ValueError("cannot merge histograms with different v0")
            count += s["count"]
            total += s["sum"]
            lo = min(lo, s["min"])
            hi = max(hi, s["max"])
            for i, c in s["buckets"].items():
                buckets[int(i)] = buckets.get(int(i), 0) + c
        out = {"count": count, "sum": total, "v0": v0, "min": lo, "max": hi,
               "mean": total / count, "buckets": buckets}
        out.update(Histogram.percentiles_of(out))
        return out


class MetricsRegistry:
    """Named instruments behind ONE lock; see module docstring."""

    def __init__(self):
        self.lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    # ------------------------------------------------------------ creation

    def counter(self, name: str) -> Counter:
        with self.lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name, self.lock)
            return c

    def counters(self, prefix: str, keys: Sequence[str]) -> Dict[str, Counter]:
        """Get-or-create a named group: {key: Counter(f"{prefix}/{key}")}."""
        return {k: self.counter(f"{prefix}/{k}") for k in keys}

    def gauge(self, name: str,
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        with self.lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name, self.lock, fn=fn)
            elif fn is not None:
                g.fn = fn
            return g

    def histogram(self, name: str, v0: float = 1e-7,
                  nbuckets: int = 44) -> Histogram:
        with self.lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(name, self.lock, v0=v0,
                                                  nbuckets=nbuckets)
            return h

    # ------------------------------------------------------------- reading

    def read(self, counters: Dict[str, Counter]) -> Dict[str, float]:
        """Atomic multi-counter read: one lock acquisition for the whole
        group, so cross-counter invariants hold in the returned dict."""
        with self.lock:
            return {k: c.value for k, c in counters.items()}

    def read_groups(self, groups: Sequence[Dict[str, Counter]]
                    ) -> List[Dict[str, float]]:
        """Atomic read across SEVERAL groups (e.g. all replicas) under one
        lock acquisition — the aggregate and the decomposition are
        mutually consistent."""
        with self.lock:
            return [{k: c.value for k, c in g.items()} for g in groups]

    def snapshot(self) -> dict:
        """Point-in-time copy of every instrument. Gauge callbacks run
        under the lock (keep them cheap; never re-enter the registry)."""
        with self.lock:
            return {
                "counters": {n: c.value for n, c in self._counters.items()},
                "gauges": {n: g.read_locked()
                           for n, g in self._gauges.items()},
                "histograms": {n: h.snapshot_locked()
                               for n, h in self._hists.items()},
            }
