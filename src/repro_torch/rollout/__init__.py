"""Device-resident rollouts: the third design point on the paper's axis.

Mirrors ``repro.rollout``. The paper's CPU/GPU-ratio analysis says env
interaction on host CPUs is the performance and power limiter of
distributed RL; this package moves it off the host. Three design points
coexist, all behind `SeedSystem`:

  1. **per-step host** (`backend="host"`, E=1): one env step per inference
     round trip — the SEED baseline.
  2. **vectorized host** (`backend="host"`, E>1): each actor steps E lanes
     (`SyncVectorEnv` / `TorchVectorEnv`) per round trip, amortizing the
     round trip and the Python dispatch over E.
  3. **device-resident** (`backend="device"`): `DeviceRolloutEngine` fuses
     env step and policy forward into one T-step unroll over E lanes,
     captured once as a CUDA graph and replayed per unroll — ONE transfer
     per unroll (the trajectory), not one per step.
  4. **engine-sharded device** (`backend="device"`, `engine_shards=K`):
     `ShardedRolloutEngine` partitions the lanes into K engines placed
     round-robin over the CUDA devices; on one card the K replays share it.

`RolloutWorker` threads drive repeated unrolls, refresh params from the
learner between them (with an on-policy lag counter), and feed the same
trajectory sink as the host actors.
"""

from repro_torch.rollout.engine import (DeviceRolloutEngine,  # noqa: F401
                                        ShardedRolloutEngine, action_generator,
                                        as_torch_env)
from repro_torch.rollout.worker import RolloutWorker  # noqa: F401
