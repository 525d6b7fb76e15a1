"""Fault tolerance for the launch layer: re-exports of
``repro_torch.fault.supervisor``, as ``repro.launch.ft`` re-exports
``repro.fault``. ``reshard_state`` (restore onto another mesh) waits for
sharding."""

from repro_torch.fault.supervisor import (HeartbeatMonitor, RestartBudget,
                                          SimulatedFailure, Supervisor)

__all__ = ["HeartbeatMonitor", "RestartBudget", "SimulatedFailure", "Supervisor"]
