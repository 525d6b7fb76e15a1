"""Continuous invariant auditor: re-check conservation laws *while
training runs*.

A copy of ``repro.telemetry.audit`` (pure Python), kept so that the port
imports nothing of the JAX package.

The repo's strongest correctness claims are conservation invariants —
the trajectory queue's frame ledger (``generated == trained + dropped +
pending``), counters that only go up, slot tables and queue depths that
stay within their declared bounds. Tests assert them at quiescence
(after `run()` returns, every lock released); this module asserts them
*live*, every `interval_s`, from a background thread racing the real
workload. That is a strictly stronger check: a ledger that is conserved
at shutdown but transiently violated under the queue lock's release
points would pass every tier-1 test and still corrupt any consumer that
reads `stats()` mid-run (the autoscaler this plane feeds, the `/metrics`
scrape, the `BottleneckReport`).

Checks are callables returning a list of violation strings (empty =
clean) so each check can read its subsystem's state under that
subsystem's own lock — the auditor imposes no lock order of its own.
Violations escalate through `on_violation` (wired by `Telemetry` to a
health event + a flight-recorder postmortem) exactly once per distinct
message: a persistently broken invariant is one incident, not one per
tick.
"""

import threading
import time
from typing import Callable, Dict, List, Optional

__all__ = ["InvariantAuditor"]


class InvariantAuditor:
    """Background invariant re-checker; see module docstring.

    - `add_check(name, fn)`: fn() -> list of violation strings.
    - `watch_registry(name, registry)`: built-in counter-monotonicity
      check over a `MetricsRegistry` (compares successive snapshots).
    - `tick()`: run every check once (also callable inline from tests);
      `start()`/`stop()` run it on a daemon thread every `interval_s`.
    - `violations`: every distinct violation seen, with tick + check
      name — the acceptance bar for a clean run is this staying empty.
    """

    def __init__(self, interval_s: float = 0.25,
                 on_violation: Optional[Callable[[str, str], None]] = None):
        self.interval_s = interval_s
        self.on_violation = on_violation
        self.ticks = 0
        self.violations: List[dict] = []
        self._checks: Dict[str, Callable[[], List[str]]] = {}
        self._registries: Dict[str, object] = {}
        self._prev_counters: Dict[str, Dict[str, float]] = {}
        self._seen: set = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def add_check(self, name: str, fn: Callable[[], List[str]]):
        with self._lock:
            self._checks[name] = fn

    def watch_registry(self, name: str, registry):
        """Audit a `MetricsRegistry` for counter monotonicity: a counter
        observed lower than its previous snapshot means lost work or a
        torn read — both reportable."""
        with self._lock:
            self._registries[name] = registry

    # ------------------------------------------------------------- ticking

    def tick(self) -> List[str]:
        """Run all checks once; returns NEW violations found this tick."""
        with self._lock:
            checks = dict(self._checks)
            registries = dict(self._registries)
        found: List[tuple] = []
        for name, fn in checks.items():
            try:
                found.extend((name, msg) for msg in fn())
            except Exception as exc:     # a check crashing is itself a finding
                found.append((name, f"check raised: {exc!r}"))
        for rname, reg in registries.items():
            try:
                snap = reg.snapshot()["counters"]
            except Exception:
                continue
            prev = self._prev_counters.get(rname, {})
            for cname, value in snap.items():
                if cname in prev and value < prev[cname]:
                    found.append((
                        "counter_monotonic",
                        f"{rname}:{cname} went backwards "
                        f"({prev[cname]} -> {value})"))
            self._prev_counters[rname] = dict(snap)

        new = []
        with self._lock:
            self.ticks += 1
            tick = self.ticks
            for check, msg in found:
                key = (check, msg)
                if key in self._seen:
                    continue
                self._seen.add(key)
                self.violations.append({"tick": tick, "check": check,
                                        "message": msg,
                                        "ts": time.perf_counter()})
                new.append((check, msg))
        for check, msg in new:
            if self.on_violation is not None:
                try:
                    self.on_violation(check, msg)
                except Exception:
                    pass                 # escalation must not kill the auditor
        return [msg for _, msg in new]

    # ----------------------------------------------------------- lifecycle

    def start(self):
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="telemetry-auditor",
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
                self.tick()
            except Exception:
                pass                     # the auditor must never kill a run
