"""Fixed-capacity in-memory time-series store — the autoscaler's senses.

A copy of ``repro.telemetry.timeseries`` (pure Python), kept so that the port
imports nothing of the JAX package.

The registry (`metrics.py`) answers *"what are the totals right now?"*;
a closed-loop controller needs *"how are they MOVING?"* — frames/s over
the last 10 s, the derivative of queue depth, whether p99 latency has
been above its ceiling for most of a window. `TimeSeriesStore` is the
bridge: a sampler tick (`sample()`) pulls flat ``{name: value}`` dicts
from registered *sources* (built by `SeedSystem` over one atomic
`TrajectoryQueue.stats()` / `InferenceServer.stats` read each, so the
points inherit the registry's snapshot consistency) and appends one
``(t, value)`` point per series into a bounded ring.

Memory is O(series x capacity) and append is O(1): each series is a
``deque(maxlen=capacity)``, so the store holds the newest
``capacity * interval`` seconds of history and silently forgets the
rest — a controller only ever reasons over bounded windows, and an
unbounded store would be a slow leak on a week-long run.

Query surface (all windowed, all finite, all safe on empty series):

- ``window(name, w)``   — the raw ``(t, v)`` points newer than ``now-w``;
- ``latest(name)``      — newest value (None when empty);
- ``rate(name, w)``     — per-second rate of a CUMULATIVE counter over
  the window: ``(v_last - v_first) / (t_last - t_first)``, clamped at 0
  so a counter reset (learner restart) reads as a stall, not a negative
  rate;
- ``derivative(name, w)`` — same slope WITHOUT the clamp, for gauges
  (queue depth growing vs draining is exactly the sign);
- ``mean(name, w)`` / ``ewma(name, halflife_s)`` — level estimates; the
  EWMA weights each point by ``0.5 ** (age / halflife)`` so it is
  well-defined on irregular tick spacing.

`dump(window_s)` renders every series' recent points as plain JSON-able
lists — the ``/timeseries`` ops endpoint's body.
"""

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["TimeSeries", "TimeSeriesStore"]


class TimeSeries:
    """One named ring of ``(t, value)`` points (perf_counter timebase)."""

    __slots__ = ("name", "points")

    def __init__(self, name: str, capacity: int):
        self.name = name
        self.points: "deque" = deque(maxlen=capacity)

    def append(self, t: float, v: float):
        self.points.append((t, float(v)))

    # ------------------------------------------------------------- queries

    def window(self, window_s: float,
               now: Optional[float] = None) -> List[Tuple[float, float]]:
        now = time.perf_counter() if now is None else now
        cut = now - window_s
        return [(t, v) for t, v in self.points if t >= cut]

    def latest(self) -> Optional[float]:
        return self.points[-1][1] if self.points else None

    def _slope(self, window_s: float, now: Optional[float]) -> float:
        pts = self.window(window_s, now)
        if len(pts) < 2:
            return 0.0
        (t0, v0), (t1, v1) = pts[0], pts[-1]
        if t1 <= t0:
            return 0.0
        return (v1 - v0) / (t1 - t0)

    def rate(self, window_s: float, now: Optional[float] = None) -> float:
        """Per-second rate of a cumulative counter (clamped at 0)."""
        return max(self._slope(window_s, now), 0.0)

    def derivative(self, window_s: float,
                   now: Optional[float] = None) -> float:
        """Signed slope of a gauge over the window."""
        return self._slope(window_s, now)

    def mean(self, window_s: float, now: Optional[float] = None) -> float:
        pts = self.window(window_s, now)
        if not pts:
            return 0.0
        return sum(v for _, v in pts) / len(pts)

    def ewma(self, halflife_s: float, now: Optional[float] = None) -> float:
        """Age-weighted mean (weight ``0.5 ** (age/halflife)``) — robust
        to irregular tick spacing, unlike the classic recursive form."""
        now = time.perf_counter() if now is None else now
        num = den = 0.0
        for t, v in self.points:
            w = 0.5 ** (max(now - t, 0.0) / max(halflife_s, 1e-9))
            num += w * v
            den += w
        return num / den if den > 0 else 0.0


class TimeSeriesStore:
    """Named rings fed by registered sources; one lock for the whole
    store so a reader never sees a tick half-ingested across series
    (the same single-lock discipline `MetricsRegistry` uses).

    ``add_source(fn)`` registers ``fn() -> {name: numeric}``; `sample()`
    runs every source (exceptions swallowed per-source — one dead
    provider must not blind the controller to the others) and stamps all
    returned values with ONE shared timestamp.
    """

    def __init__(self, capacity: int = 512):
        if not isinstance(capacity, int) or capacity < 2:
            raise ValueError(
                f"capacity must be an int >= 2 points, got {capacity!r}")
        self.capacity = capacity
        self.samples = 0                    # sample() calls, for tests/stats
        self._series: Dict[str, TimeSeries] = {}
        self._sources: List[Callable[[], Dict[str, float]]] = []
        self._lock = threading.Lock()

    def add_source(self, fn: Callable[[], Dict[str, float]]):
        self._sources.append(fn)

    def series(self, name: str) -> TimeSeries:
        with self._lock:
            s = self._series.get(name)
            if s is None:
                s = self._series[name] = TimeSeries(name, self.capacity)
            return s

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    # ------------------------------------------------------------ feeding

    def record(self, name: str, value: float, t: Optional[float] = None):
        t = time.perf_counter() if t is None else t
        s = self.series(name)
        with self._lock:
            s.append(t, value)

    def sample(self, now: Optional[float] = None) -> dict:
        """One tick: pull every source, ingest under one timestamp.
        Returns the flat dict that was ingested (handy for tests)."""
        now = time.perf_counter() if now is None else now
        flat: Dict[str, float] = {}
        for fn in self._sources:
            try:
                for k, v in fn().items():
                    if isinstance(v, bool) or not isinstance(v, (int, float)):
                        continue
                    flat[k] = float(v)
            except Exception:
                continue          # a dead source must not blind the rest
        with self._lock:
            for k, v in flat.items():
                s = self._series.get(k)
                if s is None:
                    s = self._series[k] = TimeSeries(k, self.capacity)
                s.append(now, v)
            self.samples += 1
        return flat

    # ------------------------------------------------------------ queries

    def latest(self, name: str) -> Optional[float]:
        return self.series(name).latest()

    def rate(self, name: str, window_s: float,
             now: Optional[float] = None) -> float:
        return self.series(name).rate(window_s, now)

    def derivative(self, name: str, window_s: float,
                   now: Optional[float] = None) -> float:
        return self.series(name).derivative(window_s, now)

    def mean(self, name: str, window_s: float,
             now: Optional[float] = None) -> float:
        return self.series(name).mean(window_s, now)

    def ewma(self, name: str, halflife_s: float,
             now: Optional[float] = None) -> float:
        return self.series(name).ewma(halflife_s, now)

    def dump(self, window_s: float = 120.0) -> dict:
        """JSON-able snapshot of every series' recent window — the
        ``/timeseries`` endpoint body. Points are ``[t, v]`` pairs on the
        perf_counter timebase plus a shared ``now`` so consumers can
        compute ages without clock agreement."""
        now = time.perf_counter()
        with self._lock:
            series = {
                name: [[t, v] for t, v in s.points if t >= now - window_s]
                for name, s in self._series.items()}
        return {"now": now, "window_s": window_s, "samples": self.samples,
                "capacity": self.capacity, "series": series}
