"""Heartbeat registry + watchdog: liveness for every long-running loop.

A copy of ``repro.telemetry.health`` (pure Python), kept so that the port
imports nothing of the JAX package.

The fail-fast seams built so far (`InferenceServer._fatal`, poison
`ReplyError`s, the actor-host pool's hard timeout) only fire when
something *dies loudly*. A replica wedged inside `policy_step`, an actor
host whose process deadlocked, or a learner stuck on a batch source dies
*silently* — the system keeps running at a fraction of its throughput
until the pool timeout (90 s of grace) finally trips. This module makes
those visible in seconds:

- `HeartbeatRegistry`: every long-running loop stamps `beat(name)` once
  per iteration. The stamp is ONE `time.perf_counter()` read plus a
  GIL-atomic dict store — cheap enough for the replica batch loop and the
  shm ring poller. Components `register` with a `stale_after_s` deadline
  (or ``None`` for loops whose idle periods are legitimate, e.g. a
  blocking TCP reader between frames — their age is reported but never
  flips the verdict) and `unregister` on clean exit so shutdown doesn't
  read as death.
- `Watchdog`: a thread that classifies heartbeat ages into a
  `HealthReport` every `interval_s`: ``healthy`` (nothing stale),
  ``degraded`` (some watched component stale, or a recent health event),
  ``stalled`` (every watched component stale). On the transition *into*
  an unhealthy verdict it fires ``on_unhealthy(report)`` — the flight
  recorder's hook — rate-limited so a persistently wedged component
  produces one postmortem, not one per tick.

`HeartbeatRegistry.event()` is the escalation path for non-heartbeat
failures (auditor invariant violations): events are timestamped, kept in
a bounded ring, and force the verdict to at least ``degraded`` while
recent (`event_window_s`).
"""

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

__all__ = ["HeartbeatRegistry", "HealthReport", "Watchdog"]


@dataclass
class HealthReport:
    """One classification of the system's liveness at `ts` (perf_counter
    timebase). ``components`` maps heartbeat name -> {age_s,
    stale_after_s, stale}; informational components (stale_after_s None)
    never contribute to the verdict."""

    verdict: str                          # healthy | degraded | stalled
    ts: float
    components: Dict[str, dict] = field(default_factory=dict)
    events: List[dict] = field(default_factory=list)

    @property
    def stale(self) -> List[str]:
        return sorted(n for n, c in self.components.items() if c["stale"])

    def as_dict(self) -> dict:
        return {"verdict": self.verdict, "ts": self.ts,
                "stale": self.stale,
                "components": {n: dict(c)
                               for n, c in self.components.items()},
                "events": [dict(e) for e in self.events]}

    def __str__(self):
        parts = [f"HealthReport: {self.verdict}"]
        if self.stale:
            parts.append(f"stale={','.join(self.stale)}")
        if self.events:
            parts.append(f"events={len(self.events)}")
        return " ".join(parts)


class HeartbeatRegistry:
    """Liveness stamps for named components; see module docstring.

    `beat` is the hot-path call: a perf_counter read + dict store (both
    GIL-atomic), no lock. Unknown names auto-register with
    `default_stale_after_s` so callers that cannot easily register first
    (the actor-host heartbeat relay) still get watched."""

    def __init__(self, default_stale_after_s: float = 5.0,
                 event_window_s: float = 30.0, max_events: int = 64):
        self.default_stale_after_s = default_stale_after_s
        self.event_window_s = event_window_s
        self._beats: Dict[str, float] = {}
        self._stale_after: Dict[str, Optional[float]] = {}
        self._events: deque = deque(maxlen=max_events)
        self._lock = threading.Lock()

    # ----------------------------------------------------------- stamping

    def register(self, name: str, stale_after_s: Optional[float] = None):
        """Declare a component and its staleness deadline. ``None`` means
        informational: age is reported, the verdict never flips on it
        (blocking readers whose idle gaps are legitimate)."""
        with self._lock:
            self._stale_after[name] = stale_after_s
            self._beats.setdefault(name, time.perf_counter())

    def beat(self, name: str):
        if name not in self._stale_after:       # auto-register (see doc)
            with self._lock:
                self._stale_after.setdefault(name,
                                             self.default_stale_after_s)
        self._beats[name] = time.perf_counter()

    def unregister(self, name: str):
        """Clean exit: a loop that stopped on purpose must not read as
        stalled forever after."""
        with self._lock:
            self._stale_after.pop(name, None)
            self._beats.pop(name, None)

    def event(self, component: str, message: str):
        """Record a health event (e.g. an auditor violation); recent
        events force the verdict to at least ``degraded``."""
        with self._lock:
            self._events.append({"ts": time.perf_counter(),
                                 "component": component,
                                 "message": message})

    # ------------------------------------------------------------ reading

    def ages(self) -> Dict[str, float]:
        now = time.perf_counter()
        with self._lock:
            return {n: now - t for n, t in self._beats.items()}

    def report(self) -> HealthReport:
        now = time.perf_counter()
        with self._lock:
            beats = dict(self._beats)
            deadlines = dict(self._stale_after)
            events = [dict(e) for e in self._events
                      if now - e["ts"] <= self.event_window_s]
        components = {}
        watched = stale = 0
        for name, t in beats.items():
            limit = deadlines.get(name)
            age = now - t
            is_stale = limit is not None and age > limit
            if limit is not None:
                watched += 1
                stale += is_stale
            components[name] = {"age_s": age, "stale_after_s": limit,
                                "stale": is_stale}
        if watched and stale == watched:
            verdict = "stalled"
        elif stale or events:
            verdict = "degraded"
        else:
            verdict = "healthy"
        return HealthReport(verdict=verdict, ts=now, components=components,
                            events=events)


class Watchdog:
    """Background classifier over a `HeartbeatRegistry`; caches `latest`
    for the `/healthz` endpoint and fires `on_unhealthy` once per
    transition into an unhealthy verdict (rate-limited by
    `refire_after_s` so a persistent wedge re-reports occasionally, not
    every tick)."""

    def __init__(self, registry: HeartbeatRegistry, interval_s: float = 0.25,
                 on_unhealthy: Optional[Callable[[HealthReport], None]] = None,
                 refire_after_s: float = 60.0):
        self.registry = registry
        self.interval_s = interval_s
        self.on_unhealthy = on_unhealthy
        self.refire_after_s = refire_after_s
        self.latest: Optional[HealthReport] = None
        self.transitions = 0                 # healthy -> unhealthy edges seen
        self._last_fire = 0.0
        self._was_unhealthy = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def check(self) -> HealthReport:
        """One classification tick (also callable inline from tests)."""
        rep = self.registry.report()
        self.latest = rep
        unhealthy = rep.verdict != "healthy"
        if unhealthy and not self._was_unhealthy:
            self.transitions += 1
            now = time.perf_counter()
            if self.on_unhealthy is not None and \
                    now - self._last_fire > self.refire_after_s / 60.0:
                self._last_fire = now
                try:
                    self.on_unhealthy(rep)
                except Exception:
                    pass                 # the watchdog must never kill a run
        self._was_unhealthy = unhealthy
        return rep

    def start(self):
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="telemetry-watchdog",
                                        daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.check()
            except Exception:
                pass                     # see check(): never kill the run
