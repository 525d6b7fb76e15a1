"""Fault tolerance for the serving plane: a copy of ``repro.fault``.

  * `BackoffPolicy` — bounded exponential backoff with seeded jitter
    (frozen dataclass: pickles across spawn with the host config), the
    wire transports' reconnect schedule;
  * `RestartBudget` — restarts-per-window budget shared by the launch
    `Supervisor` and the actor-host supervisor
    (`launch.actor_host.ActorHostPool(supervise=True)`);
  * `Supervisor` / `SimulatedFailure` — restore-and-retry around a
    training loop;
  * `HeartbeatMonitor` — straggler detection over actor heartbeats;
  * `ChaosMonkey` / `ChaosEvent` — deterministic seeded fault injection
    against a live `SeedSystem` (see `repro_torch.fault.chaos`).

Everything here is OPT-IN: `reconnect=None` transports fail fast,
`supervise=False` pools die loud, and a `SeedSystem` without
`checkpoint_dir` never touches disk.
"""

from repro_torch.fault.backoff import BackoffPolicy
from repro_torch.fault.chaos import ACTIONS, ChaosEvent, ChaosMonkey
from repro_torch.fault.supervisor import (HeartbeatMonitor, RestartBudget,
                                          SimulatedFailure, Supervisor)

__all__ = [
    "ACTIONS", "BackoffPolicy", "ChaosEvent", "ChaosMonkey",
    "HeartbeatMonitor", "RestartBudget", "SimulatedFailure", "Supervisor",
]
