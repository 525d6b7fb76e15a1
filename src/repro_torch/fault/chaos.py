"""Deterministic fault injection for the serving plane.

A copy of ``repro.fault.chaos`` (pure Python), kept so that the port
imports nothing of the JAX package.

A resilience claim that was never exercised is a comment, not a feature.
`ChaosMonkey` drives the four failure domains the survivable serving
plane is built to absorb, each through the narrowest seam the real
failure would use — no test-only hooks inside the hot paths:

  * ``kill_actor_host``    -> `ActorHostPool.kill_host` (SIGKILL, no
                              cleanup, no final stats — the worst-case
                              process death);
  * ``sever_gateway_conn`` -> `InferenceGateway.sever_connection`
                              (RST-style shutdown of one live accepted
                              socket: the client sees a mid-request
                              ConnectionError, the gateway reader takes
                              its normal sever path);
  * ``wedge_replica``      -> swap `InferenceServer.policy_step` (the
                              replicas look the attribute up at call
                              time) with a wrapper that sleeps inside
                              exactly one replica thread — a GC pause /
                              page-fault storm stand-in;
  * ``crash_learner_step`` -> swap `Learner.train_step` with a one-shot
                              `SimulatedFailure` raiser: the learner
                              thread dies exactly as an OOM/assert would,
                              and `SeedSystem.resume()` must bring the
                              run back.

Schedules are DATA (`ChaosEvent` lists), either scripted or derived from
a seed — `ChaosMonkey.random(seed=...)` builds the same schedule every
time, so a chaos run that fails in CI replays bit-identically from its
logged seed. The monkey runs on its own daemon thread against a live
`SeedSystem`; every injection (and any injection error) is recorded in
``injected`` for the test to assert against.
"""

import random
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from repro_torch.fault.supervisor import SimulatedFailure

ACTIONS = ("kill_actor_host", "sever_gateway_conn", "wedge_replica",
           "crash_learner_step")


@dataclass(frozen=True)
class ChaosEvent:
    """One scheduled fault: `action` against `target` at `at_s` seconds
    after the monkey starts. `duration_s` only matters for wedges."""
    at_s: float
    action: str
    target: int = 0
    duration_s: float = 0.5

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(
                f"unknown chaos action {self.action!r}; use one of "
                f"{ACTIONS}")
        if self.at_s < 0:
            raise ValueError(f"at_s must be >= 0, got {self.at_s}")


@dataclass
class ChaosMonkey:
    events: List[ChaosEvent] = field(default_factory=list)

    def __post_init__(self):
        self.events = sorted(self.events, key=lambda e: e.at_s)
        # (wall_at_s, event, ok, error) per attempted injection
        self.injected: List[Tuple[float, ChaosEvent, bool,
                                  Optional[str]]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._system = None

    # ------------------------------------------------------- construction

    @classmethod
    def scripted(cls, *events: ChaosEvent) -> "ChaosMonkey":
        return cls(list(events))

    @classmethod
    def random(cls, seed: int, horizon_s: float, n_events: int = 4,
               actions: Sequence[str] = ACTIONS,
               max_target: int = 4) -> "ChaosMonkey":
        """A seeded schedule: same (seed, horizon_s, n_events, actions)
        -> the same events, every process, every platform — chaos runs
        replay from their logged seed."""
        rng = random.Random(seed)
        events = [ChaosEvent(
            at_s=round(rng.uniform(0.1 * horizon_s, 0.8 * horizon_s), 3),
            action=rng.choice(list(actions)),
            target=rng.randrange(max_target))
            for _ in range(n_events)]
        return cls(events)

    # ------------------------------------------------------------ driving

    def start(self, system) -> None:
        """Begin injecting against a live `SeedSystem` (call right after
        its run() is launched). Daemon thread: a dead monkey cannot hang
        the run it was tormenting."""
        if self._thread is not None:
            raise RuntimeError("ChaosMonkey already started")
        self._system = system
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="chaos-monkey")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _loop(self):
        t0 = time.perf_counter()
        for ev in self.events:
            delay = t0 + ev.at_s - time.perf_counter()
            if delay > 0 and self._stop.wait(delay):
                return
            if self._stop.is_set():
                return
            ok, err = True, None
            try:
                getattr(self, f"_{ev.action}")(ev)
            except Exception as e:
                ok, err = False, f"{type(e).__name__}: {e}"
            self.injected.append(
                (time.perf_counter() - t0, ev, ok, err))

    # --------------------------------------------------------- injections

    def _kill_actor_host(self, ev: ChaosEvent):
        pool = self._system.pool
        if pool is None:
            raise RuntimeError("no actor-host pool (wire transports only)")
        if not pool.kill_host(ev.target % max(pool.num_hosts, 1)):
            raise RuntimeError(f"host {ev.target} not alive to kill")

    def _sever_gateway_conn(self, ev: ChaosEvent):
        gws = self._system.gateways
        if not gws:
            raise RuntimeError("no gateways (wire transports only)")
        gw = gws[ev.target % len(gws)]
        if not gw.sever_connection():
            raise RuntimeError("gateway has no live connection to sever")

    def _wedge_replica(self, ev: ChaosEvent):
        srv = self._system.server
        if srv is None:
            raise RuntimeError("no inference server (host backend only)")
        orig = srv.policy_step
        tname = f"inference-replica-{ev.target % srv.num_replicas}"
        fired = threading.Event()

        def wedged(obs, ids):
            # one replica thread stalls once for duration_s; siblings and
            # later calls pass straight through to the real policy
            if threading.current_thread().name == tname \
                    and not fired.is_set():
                fired.set()
                time.sleep(ev.duration_s)
                srv.policy_step = orig
            return orig(obs, ids)

        srv.policy_step = wedged

    def _crash_learner_step(self, ev: ChaosEvent):
        ln = self._system.learner
        if ln is None:
            raise RuntimeError("no learner to crash")
        orig = ln.train_step
        fired = threading.Event()

        def crashing(state, batch):
            if not fired.is_set():
                fired.set()
                ln.train_step = orig    # one-shot: resume() must succeed
                raise SimulatedFailure("chaos: injected learner crash")
            return orig(state, batch)

        ln.train_step = crashing
