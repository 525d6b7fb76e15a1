"""Restart policy and supervision primitives: a copy of
``repro.fault.supervisor`` (pure Python).

One `RestartBudget` backs every restart decision in the system — the
checkpoint-restoring `Supervisor` (train-loop restarts), the actor-host
supervisor inside `ActorHostPool` (child-process respawns), and the
straggler-restarting `HeartbeatMonitor` — so "how many times may a
component die before the run is declared dead" is a single policy with
a single sliding-window implementation.
"""

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional


class SimulatedFailure(RuntimeError):
    """Raised by failure-injection hooks in tests/examples."""


class RestartBudget:
    """Sliding-window restart allowance: at most `max_restarts` within
    any `window_s`-second window. `spend()` records a restart and returns
    True while the budget holds; False means give up."""

    def __init__(self, max_restarts: int = 5, window_s: float = 3600.0):
        self.max_restarts = max_restarts
        self.window_s = window_s
        self.restarts: List[float] = []          # monotonic timestamps

    def spend(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        self.restarts[:] = [t for t in self.restarts
                            if now - t < self.window_s]
        self.restarts.append(now)
        return len(self.restarts) <= self.max_restarts

    @property
    def spent(self) -> int:
        return len(self.restarts)


@dataclass
class Supervisor:
    """Runs a train loop under a restart budget, restoring the latest
    checkpoint after each (simulated) failure.

    `ckpt` is a `repro_torch.checkpoint.CheckpointManager`; typed loosely
    so the fault layer imports nothing of the checkpoint layer.
    """

    ckpt: object
    max_restarts: int = 5
    restart_window_s: float = 3600.0
    _budget: Optional[RestartBudget] = field(default=None, repr=False)

    def __post_init__(self):
        if self._budget is None:
            self._budget = RestartBudget(self.max_restarts,
                                         self.restart_window_s)

    @property
    def restarts(self) -> List[float]:
        return self._budget.restarts

    def run(self, make_state: Callable, train_loop: Callable):
        """make_state() -> fresh state; train_loop(state, start_step) runs
        until completion or raises. Returns the final state."""
        state = make_state()
        start = 0
        if self.ckpt.latest_step() is not None:
            state, start = self.ckpt.restore(state)
        while True:
            try:
                return train_loop(state, start)
            except SimulatedFailure as e:
                if not self._budget.spend():
                    raise RuntimeError(
                        f"{self._budget.spent} restarts within window") from e
                state = make_state()
                start = 0
                if self.ckpt.latest_step() is not None:
                    state, start = self.ckpt.restore(state)


@dataclass
class HeartbeatMonitor:
    """Declares stalled actors stragglers and restarts them."""
    stall_s: float = 10.0
    _last: dict = field(default_factory=dict)

    def check(self, actors) -> List[int]:
        now = time.monotonic()
        stragglers = []
        for a in actors:
            steps, t = self._last.get(a.actor_id, (-1, now))
            if a.steps != steps:
                self._last[a.actor_id] = (a.steps, now)
            elif now - t > self.stall_s:
                stragglers.append(a.actor_id)
        return stragglers

    def restart(self, actors, straggler_ids):
        for a in actors:
            if a.actor_id in straggler_ids:
                a.stop()
                a.join(timeout=1.0)
                a._stop.clear()
                a.start()
                self._last.pop(a.actor_id, None)
