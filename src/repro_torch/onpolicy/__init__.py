"""On-policy training plane: staleness-aware trajectory flow into a
V-trace learner, beside (not instead of) the replay plane.

Mirrors ``repro.onpolicy``. `SeedSystem(algo="vtrace")` wires the pieces:
`TrajectoryQueue` admits param-version-stamped unrolls and drops
stale/overflow ones under a conserved frame ledger, `VTraceBatcher`
assembles (B, T) batches for `make_vtrace_train_step`, and the
sampling-policy adapters generate behavior logprobs on the host inference
path (`SamplingPolicy`) or for the device backend
(`make_device_sampling_policy`).
"""

from repro_torch.onpolicy.batcher import VTraceBatcher, assemble_vtrace_batch
from repro_torch.onpolicy.learner import (SamplingPolicy, VTraceLearner,
                                          make_device_sampling_policy,
                                          make_vtrace_train_step, mlp_actor_critic)
from repro_torch.onpolicy.queue import Closed, TrajectoryQueue

__all__ = [
    "Closed",
    "SamplingPolicy",
    "TrajectoryQueue",
    "VTraceBatcher",
    "VTraceLearner",
    "assemble_vtrace_batch",
    "make_device_sampling_policy",
    "make_vtrace_train_step",
    "mlp_actor_critic",
]
