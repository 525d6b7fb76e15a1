"""Fault tolerance for the launch layer: re-exports of
``repro_torch.fault.supervisor``, as ``repro.launch.ft`` re-exports
``repro.fault``, and ``reshard_state``, which restores a checkpoint onto
another mesh (elastic scale-up or scale-down after losing or gaining a
slice): checkpoint leaves are whole host arrays, so restoring is each rank
copying its own shards into a state laid out by ``launch.specs``.
"""

from typing import Optional

from repro_torch.checkpoint import CheckpointManager
from repro_torch.fault.supervisor import (HeartbeatMonitor, RestartBudget,
                                          SimulatedFailure, Supervisor)

__all__ = ["HeartbeatMonitor", "RestartBudget", "SimulatedFailure", "Supervisor",
           "reshard_state"]


def reshard_state(ckpt: CheckpointManager, bundle, optimizer, cfg, new_mesh,
                  step: Optional[int] = None):
    """Elastic re-mesh: the latest checkpoint (or `step`'s) restored onto
    `new_mesh` with ``state_specs``' placements, the params by the
    config's rules and the moments by ZeRO-1's, every shard on the mesh's
    device type. Returns (state, step)."""
    from repro_torch.launch.specs import state_specs
    from repro_torch.sharding.param import empty_like_on, materialize

    device = new_mesh.device_type
    spec = state_specs(bundle, optimizer, new_mesh, cfg)
    template = {"params": materialize(spec["params"], device),
                "opt_state": {k: {n: empty_like_on(t, device) for n, t in v.items()}
                              for k, v in spec["opt_state"].items()},
                "step": spec["step"]}
    return ckpt.restore(template, step=step)
