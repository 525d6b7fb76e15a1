"""Fault tolerance for the serving plane: the pieces of ``repro.fault``
that the port has.

  * `BackoffPolicy` — bounded exponential backoff with seeded jitter
    (frozen dataclass: pickles across spawn with the host config), the
    wire transports' reconnect schedule;
  * `RestartBudget` — restarts-per-window budget shared by the launch
    `Supervisor` and the actor-host supervisor
    (`launch.actor_host.ActorHostPool(supervise=True)`);
  * `Supervisor` / `SimulatedFailure` — restore-and-retry around a
    training loop;
  * `HeartbeatMonitor` — straggler detection over actor heartbeats.

The reference's `ChaosMonkey` is not ported yet (ROADMAP queue 1, "Ops
and survival planes").
"""

from repro_torch.fault.backoff import BackoffPolicy
from repro_torch.fault.supervisor import (HeartbeatMonitor, RestartBudget,
                                          SimulatedFailure, Supervisor)

__all__ = ["BackoffPolicy", "HeartbeatMonitor", "RestartBudget",
           "SimulatedFailure", "Supervisor"]
