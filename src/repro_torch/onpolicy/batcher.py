"""V-trace batch assembly: per-lane unrolls -> (B, T) learner batches.

A copy of ``repro.onpolicy.batcher`` (numpy only), with its imports taken
from the port. Host `Actor` sinks emit the per-lane unroll schema
(`core.actor.flush_lane_unrolls`): 1-D time arrays per field, plus the
on-policy extras ``behavior_logprobs`` (stamped per step by the sampling
policy) and ``param_version`` (stamped per unroll by the generator). The
batcher stacks B of them into the exact field set `core.vtrace` consumes:
obs, actions, rewards, discounts (= gamma * (1 - done), 0 at terminals),
and behavior_logprobs, all (B, T) with time as the second axis.
"""

from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.learner import BatchSourceClosed
from repro_torch.onpolicy.queue import Closed, TrajectoryQueue


def assemble_vtrace_batch(unrolls: List[Dict[str, np.ndarray]],
                          gamma: float) -> Dict[str, np.ndarray]:
    """Stack per-lane unrolls into a (B, T) V-trace batch.

    Raises KeyError if an unroll is missing ``behavior_logprobs`` — an
    on-policy system wired to a policy that doesn't report logprobs is a
    configuration error worth failing loudly on, not a NaN factory.
    """
    if not unrolls:
        raise ValueError("cannot assemble an empty batch")
    dones = np.stack([u["dones"] for u in unrolls]).astype(np.float32)
    batch = {
        "obs": np.stack([u["obs"] for u in unrolls]),
        "actions": np.stack([u["actions"] for u in unrolls]).astype(np.int32),
        "rewards": np.stack([u["rewards"] for u in unrolls]).astype(np.float32),
        "discounts": (gamma * (1.0 - dones)).astype(np.float32),
        "behavior_logprobs": np.stack(
            [u["behavior_logprobs"] for u in unrolls]).astype(np.float32),
    }
    # ALWAYS present (zeros when unstamped), so every batch has one key set
    batch["param_version"] = np.asarray(
        [int(np.asarray(u.get("param_version", 0)).reshape(()))
         for u in unrolls], np.int64)
    return batch


class VTraceBatcher:
    """`Learner`-shaped batch source over a `TrajectoryQueue`.

    ``batcher() -> (batch, None)`` blocks until `batch_size` unrolls are
    available; a closed queue surfaces as `BatchSourceClosed`, which
    `Learner._loop` treats as a clean shutdown (the poison seam — see
    `Learner.stop`).
    """

    def __init__(self, queue: TrajectoryQueue, batch_size: int,
                 gamma: float = 0.99,
                 poll_timeout_s: Optional[float] = 0.5):
        self.queue = queue
        self.batch_size = batch_size
        self.gamma = gamma
        self.poll_timeout_s = poll_timeout_s

    def __call__(self):
        while True:
            try:
                unrolls = self.queue.pop_batch(self.batch_size,
                                               timeout=self.poll_timeout_s)
                return assemble_vtrace_batch(unrolls, self.gamma), None
            except Closed:
                raise BatchSourceClosed("trajectory queue closed") from None
            except TimeoutError:
                continue
