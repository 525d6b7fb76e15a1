"""The rollout design points side by side on Catch, no learner.

The port's counterpart of the device-backend lines of
``examples/quickstart.py``'s ``vector_actor_demo`` and
``sharded_inference_demo``, at the settings of
``benchmarks/fig3_actor_scaling.py``'s ``measured_backend_sweep`` (Fig
3d) and ``measured_engine_shard_sweep`` (Fig 3e): 2 actors on
CatchEnv(10, 5) on the device, a uniform random policy, three points at
unroll 16 —

  * per-step host (E 1) and vectorized host (E 8): actor threads step
    `TorchVectorEnv` lanes and ask the central `InferenceServer` (a host
    policy) for actions once per vector step;
  * device-resident (E 8): rollout workers run env step and policy draw as
    one 16-step unroll on the device (a CUDA graph replay on the card);

then `engine_shards` 1 and 2 on the device backend at unroll 8. One row a
point: env frames/s and the counts behind them, which must add up
(``env_frames == actor_iterations * E``, on the device ``scans * T * E``).
The last row is the reference's acceptance check (device-resident at least
the vectorized host's frames/s, ``tests/test_rollout.py``), printed, not
asserted.

    PYTHONPATH=src python -m repro_torch.launch.rollout_backends --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.core.system import SeedSystem
from repro_torch.device import resolve
from repro_torch.envs.catch import CatchEnv

# (name, backend, lanes an actor): Fig 3d's three design points
POINTS = (("per_step_host", "host", 1), ("vectorized_host", "host", 8),
          ("device_resident", "device", 8))
SHARDS = (1, 2)
ACTORS = 2


def device_policy(num_actions):
    """A uniform random `policy_apply` drawing from the engine's action
    generator."""
    def policy_apply(params, core, obs, gen):
        return torch.randint(0, num_actions, (obs.shape[0],), generator=gen,
                             device=obs.device), core
    return policy_apply


def run_point(backend, envs_per_actor, *, unroll=16, seconds=1.0, engine_shards=1,
              device="cuda"):
    """Build one point, warm it (the device backend captures its unrolls),
    run it for `seconds` without a learner and check its counts; returns
    (system, stats)."""
    dev = resolve(device)
    common = dict(env_factory=lambda: CatchEnv(device=dev), num_actors=ACTORS, unroll=unroll,
                  envs_per_actor=envs_per_actor)
    if backend == "device":
        system = SeedSystem(backend="device", policy_apply=device_policy(CatchEnv.num_actions),
                            engine_shards=engine_shards, **common)
    else:
        rng = np.random.default_rng(0)
        system = SeedSystem(
            policy_step=lambda obs, ids: rng.integers(0, CatchEnv.num_actions, obs.shape[0]),
            deadline_ms=2.0, **common)
    system.warmup()
    stats = system.run(seconds=seconds, with_learner=False)
    if stats["inference_error"]:
        raise RuntimeError(f"an actor, rollout or inference thread died:\n{stats['inference_error']}")
    per_iteration = envs_per_actor * (unroll if backend == "device" else 1)
    if not 0 < stats["env_frames"] == stats["actor_iterations"] * per_iteration:
        raise RuntimeError(f"frames {stats['env_frames']} != iterations "
                           f"{stats['actor_iterations']} x {per_iteration}")
    return system, stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises where there is no card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    kw = dict(seconds=args.seconds, device=dev)
    print(f"== rollout backends (fig3d/e): {ACTORS} actors, CatchEnv(10, 5) on {dev}, "
          f"uniform random policy, {args.seconds}s a point")
    rates = {}
    for name, backend, lanes in POINTS:
        _, stats = run_point(backend, lanes, unroll=16, **kw)
        rates[name] = stats["env_frames_per_s"]
        print(f"fig3d_{name},{lanes},{rates[name]:.1f},env_frames_per_s "
              f"iterations={stats['actor_iterations']} env_frames={stats['env_frames']}")
    for k in SHARDS:
        _, stats = run_point("device", 8, unroll=8, engine_shards=k, **kw)
        print(f"fig3e_engine_shards_{k},{stats['env_frames_per_s']:.1f},env_frames_per_s "
              f"scans={stats['scans']} env_frames={stats['env_frames']} "
              f"(= scans x 8 x 8)")
    held = rates["device_resident"] >= rates["vectorized_host"]
    print(f"device_resident >= vectorized_host: {held} "
          f"({rates['device_resident']:.1f} vs {rates['vectorized_host']:.1f} env frames/s)")
    return rates


if __name__ == "__main__":
    main()
