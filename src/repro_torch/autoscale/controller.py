"""Autoscale controller: the thread that runs sense -> decide -> act -> log.

A copy of ``repro.autoscale.controller`` (pure Python), kept so that the port
imports nothing of the JAX package.

One `tick()` is the whole loop, and it is a plain method so tests can
drive it synchronously with fabricated clocks:

1. **sense**  — `TimeSeriesStore.sample()` pulls every registered source
   (frame ledger, inference stats, recovery counters) under one
   timestamp; the live `BottleneckReport` is computed from the telemetry
   registry + a caller-supplied mid-run ``stats_fn()``.
2. **decide** — SLO verdicts + bottleneck class + the recovery-counter
   churn rate feed `AutoscalePolicy.decide`, which owns all damping
   (churn suppression, cooldown, hysteresis, bounds).
3. **act**    — a non-hold action drives exactly one seam:
   ``pool.request_grow()`` / ``pool.request_drain()`` for the actor
   plane, ``server.set_active_replicas(n +/- 1)`` for the inference
   plane. Actuators are handed in as plain objects; a missing actuator
   (in-proc backend has no pool) downgrades the action to an annotated
   hold instead of raising.
4. **log**    — every tick appends one `DecisionLog` entry carrying the
   full evidence chain: trigger series values, bottleneck class + shares,
   SLO verdicts, the action (with candidate/streak/saturation), and the
   topology before and after. ``/autoscaler`` serves `dump()`; the
   flight recorder snapshots the same dict into postmortem bundles.

The background thread is deliberately thin: ``while not stop: tick();
wait(interval)`` with a heartbeat stamp per iteration so the watchdog
sees a wedged controller, and a blanket except so a sensing bug can
degrade to "no autoscaling this tick" but never kill training.
"""

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from ..telemetry.slo import SLOSet
from ..telemetry.timeseries import TimeSeriesStore
from .policy import (CHURN_COUNTERS, Action, AutoscaleConfig,
                     AutoscalePolicy, PolicyInputs)

__all__ = ["DecisionLog", "AutoscaleController"]

# Series the decision log snapshots as "trigger values" — the numbers a
# human (or test) needs to see to believe the action was justified.
_TRIGGER_SERIES = ("frames_per_s", "frames_generated", "frames_trained",
                   "frames_dropped", "drop_rate", "infer_p99_ms",
                   "queue_depth")


class DecisionLog:
    """Append-only bounded decision history. Entries are sequence-stamped
    so scrapers can detect ring overflow (``entries[0]["seq"] > 0`` means
    older decisions aged out), and `dump()` is one lock acquisition so a
    scrape never interleaves with an append."""

    def __init__(self, capacity: int = 256):
        self._entries: "deque" = deque(maxlen=max(capacity, 1))
        self._seq = 0
        self._lock = threading.Lock()

    def append(self, entry: dict) -> dict:
        with self._lock:
            entry = dict(entry, seq=self._seq)
            self._seq += 1
            self._entries.append(entry)
        return entry

    def dump(self) -> dict:
        with self._lock:
            return {"total": self._seq, "entries": list(self._entries)}

    def entries(self) -> List[dict]:
        with self._lock:
            return list(self._entries)


class AutoscaleController:
    """Owns the policy + store + log; drives the actuator seams.

    Parameters
    ----------
    config:    the `AutoscaleConfig` opt-in knob.
    telemetry: the run's `Telemetry` (bottleneck reports, heartbeats).
    stats_fn:  ``() -> dict`` returning a mid-run stats document with at
               least ``env_frames``/``elapsed_s`` (and ``onpolicy`` when
               the vtrace queue exists) — `SeedSystem` supplies this.
    pool:      object with ``request_grow()``/``request_drain()``/
               ``live_hosts()`` (the socket backend's `ActorHostPool`),
               or None when the backend has no host plane.
    server:    object with ``set_active_replicas(n)``/``active_replicas``
               /``num_replicas`` (`InferenceServer`), or None.
    """

    def __init__(self, config: AutoscaleConfig, telemetry, *,
                 stats_fn: Callable[[], dict],
                 pool=None, server=None,
                 store: Optional[TimeSeriesStore] = None,
                 slos: Optional[SLOSet] = None):
        self.config = config
        self.telemetry = telemetry
        self.stats_fn = stats_fn
        self.pool = pool
        self.server = server
        self.store = store if store is not None \
            else TimeSeriesStore(capacity=config.capacity)
        self.slos = slos if slos is not None \
            else (config.slos or SLOSet())
        self.policy = AutoscalePolicy(config)
        self.log = DecisionLog(capacity=config.log_capacity)
        self.ticks = 0
        self.actions_applied: Dict[str, int] = {}
        self._started_wall = time.time()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ topology

    def topology(self) -> dict:
        hosts = self.pool.live_hosts() if self.pool is not None else 0
        if self.server is not None:
            active = self.server.active_replicas
            rmax = self.server.num_replicas
        else:
            active = rmax = 0
        return {"hosts": hosts, "replicas_active": active,
                "replicas_max": rmax}

    def churn_rate(self, now: Optional[float] = None) -> float:
        """Summed movement (events/s) of the recovery churn counters over
        the churn window — any positive value suppresses scaling."""
        w = max(self.config.churn_window_s, 1e-9)
        return sum(self.store.rate(f"recovery/{c}", w, now)
                   for c in CHURN_COUNTERS)

    # ---------------------------------------------------------------- tick

    def tick(self, now: Optional[float] = None) -> dict:
        """One full sense->decide->act->log cycle; returns the log entry."""
        now = time.perf_counter() if now is None else now
        self.ticks += 1

        # sense
        self.store.sample(now)
        try:
            stats = self.stats_fn() or {}
        except Exception:
            stats = {}
        try:
            report = self.telemetry.bottleneck_report(stats)
            bclass = report.bottleneck
            bdict = {"bottleneck": bclass,
                     "cpu_gpu_ratio": report.cpu_gpu_ratio,
                     "shares": dict(report.shares)}
        except Exception as e:
            bclass, bdict = "unknown", {"bottleneck": "unknown",
                                        "error": repr(e)}
        verdicts = self.slos.evaluate(self.store, now)
        topo_before = self.topology()

        # decide
        inputs = PolicyInputs(
            now=now, bottleneck=bclass, verdicts=verdicts,
            churn_rate=self.churn_rate(now),
            hosts=topo_before["hosts"],
            replicas_active=topo_before["replicas_active"],
            replicas_max=topo_before["replicas_max"])
        action = self.policy.decide(inputs)

        # act
        applied, note = False, ""
        if action.kind != "hold":
            if self.config.dry_run:
                note = "dry_run: not applied"
            else:
                applied, note = self._apply(action)
                if applied:
                    self.actions_applied[action.kind] = \
                        self.actions_applied.get(action.kind, 0) + 1

        # log
        entry = {
            "ts": time.time(), "t": now, "tick": self.ticks,
            "trigger": {name: self.store.latest(name)
                        for name in _TRIGGER_SERIES
                        if self.store.latest(name) is not None},
            "churn_rate": inputs.churn_rate,
            "bottleneck": bdict,
            "slo": {k: v.as_dict() for k, v in verdicts.items()},
            "action": action.as_dict(),
            "applied": applied, "note": note,
            "topology_before": topo_before,
            "topology_after": self.topology(),
        }
        return self.log.append(entry)

    def _apply(self, action: Action) -> tuple:
        """Drive exactly one actuator; (applied, note)."""
        try:
            if action.kind == "grow_hosts":
                if self.pool is None:
                    return False, "no actor-host pool on this backend"
                return self.pool.request_grow(), "pool.request_grow"
            if action.kind == "shrink_hosts":
                if self.pool is None:
                    return False, "no actor-host pool on this backend"
                return self.pool.request_drain(), "pool.request_drain"
            if action.kind in ("grow_replicas", "shrink_replicas"):
                if self.server is None:
                    return False, "no inference server handle"
                delta = 1 if action.kind == "grow_replicas" else -1
                n = self.server.active_replicas + delta
                got = self.server.set_active_replicas(n)
                return got == n, f"set_active_replicas({n}) -> {got}"
            return False, f"unknown action kind {action.kind!r}"
        except Exception as e:                 # actuator bug != training bug
            return False, f"actuator error: {e!r}"

    # ------------------------------------------------------------ reporting

    def dump(self) -> dict:
        """The ``/autoscaler`` endpoint body and flight-recorder snapshot."""
        cfg = self.config
        return {
            "enabled": True, "dry_run": cfg.dry_run,
            "uptime_s": round(time.time() - self._started_wall, 3),
            "ticks": self.ticks,
            "interval_s": cfg.interval_s,
            "bounds": {"min_hosts": cfg.min_hosts,
                       "max_hosts": cfg.max_hosts,
                       "min_replicas": cfg.min_replicas,
                       "max_replicas": cfg.max_replicas},
            "topology": self.topology(),
            "actions_applied": dict(self.actions_applied),
            "slos": [s.name for s in self.slos.slos],
            "decisions": self.log.dump(),
        }

    # ------------------------------------------------------------ lifecycle

    def start(self):
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="autoscaler", daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        self.telemetry.health.unregister("autoscaler")

    def _loop(self):
        hb = self.telemetry.health
        hb.register("autoscaler",
                    stale_after_s=max(10.0 * self.config.interval_s, 5.0))
        while not self._stop.wait(self.config.interval_s):
            hb.beat("autoscaler")
            try:
                self.tick()
            except Exception:        # a sensing bug must not kill training
                pass
