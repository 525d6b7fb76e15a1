"""The on-policy half of SEED, end to end: `SeedSystem(algo="vtrace")` on
Catch, on the card.

The port's counterpart of ``examples/quickstart.py``'s ``onpolicy_demo``
and of ``benchmarks/fig3_actor_scaling.py``'s ``measured_vtrace_sweep``
(Fig 3f). On the host backend (the default) actor threads step `CatchEnv` lanes
batched on the device (`envs.vector.TorchVectorEnv`) and query the central
inference server, whose `SamplingPolicy` samples each action and its
behavior logprob on the device; per-lane unrolls, stamped with the
behavior-param version, land in the bounded `TrajectoryQueue` (stale and
overflowing unrolls are dropped and counted); the learner trains V-trace
with AdamW on `mlp_actor_critic(50, 3, hidden=64)` and publishes its
params back to the policy. One Fig-3f row per actor count: generated and
trained frames/s, drop rate, the staleness of what ran and of what
trained, learner steps; the frame ledger must be conserved.

With ``--backend device`` (``onpolicy_demo``'s device half) rollout workers
run the env step and the policy's sampling forward as one T-step unroll on
the device (`repro_torch.rollout`, a CUDA graph replay an unroll on the
card), the behavior logprobs recorded in the same forward, and read the
learner's published params themselves; ``max_param_lag`` is 10 there, every
other setting as the host point.

    PYTHONPATH=src python -m repro_torch.launch.train_vtrace --device cpu \\
        --actors 1 2 --seconds 3 [--backend device | --transport shm --actor-hosts 1]

With ``--transport socket`` or ``shm`` (host backend) the actors run in
``--actor-hosts`` spawned processes, each stepping its Catch lanes on its
own CPU (``partial(CatchEnv, device="cpu")``: a child opens no CUDA
context), and dial ``--gateways`` inference gateways in this process; the
policy and the learner stay here, on `device`. A point's hosts are
``min(--actor-hosts, actors)``.

`build` wires one sweep point (``chip_smoke.py`` drives it). Every point
starts the policy and the learner from the same params, made from
`seed`. TF32 is turned off for cuBLAS's products on the card: the params
are fp32, as the reference's ``jnp.float32`` params are, and at lag 0 the
behavior and target logprobs must agree to fp32 rounding.
"""

import argparse
import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core.system import SeedSystem
from repro_torch.device import resolve
from repro_torch.envs.catch import CatchEnv
from repro_torch.onpolicy import SamplingPolicy, VTraceLearner, mlp_actor_critic
from repro_torch.optim import adamw

# the reference's learning rate and inference deadline
# (benchmarks/fig3_actor_scaling.py:232-256)
LR = 1e-3
DEADLINE_MS = 1.0
# the staleness bound of each backend's point (examples/quickstart.py:165,186)
MAX_PARAM_LAG = {"host": 50, "device": 10}


@dataclass
class VTraceRun:
    """What `build` wires: the system, the learner bundle, the sampling
    policy the server calls (its own copy of the params; None on the device
    backend) and the TF32 flag the run computes under."""
    device: torch.device
    system: SeedSystem
    learner: VTraceLearner
    policy: Optional[SamplingPolicy]
    tf32: bool


def build(actors=1, *, envs_per_actor=4, unroll=8, learner_batch=4, max_param_lag=None,
          device="cuda", seed=0, backend="host", transport="inproc", actor_hosts=1,
          gateways=1) -> VTraceRun:
    """One Fig-3f sweep point on `device`: `actors` x `envs_per_actor` lanes
    of CatchEnv(rows=10, cols=5), the MLP at hidden 64 from `seed`, AdamW,
    the reference's queue capacity (64 unrolls) and gamma (0.99),
    `max_param_lag` by default `MAX_PARAM_LAG[backend]`; one train step (on
    a copy) and, on the host backend, one warm-up policy batch at each
    server batch size it will most see, so that a measured window starts
    warm (the device backend's `SeedSystem.warmup` captures the unrolls).
    `transport` "socket" or "shm" moves the actors into `actor_hosts`
    spawned processes behind `gateways` gateways, their Catch lanes on the
    CPU."""
    dev = resolve(device)
    if max_param_lag is None:
        max_param_lag = MAX_PARAM_LAG[backend]
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    obs_dim = int(np.prod(CatchEnv(device=dev).obs_shape))
    init_fn, apply_fn = mlp_actor_critic(obs_dim, CatchEnv.num_actions)
    learner = VTraceLearner(apply_fn, adamw(LR))
    params = init_fn(torch.Generator().manual_seed(seed), dev)
    state = learner.init_state(params)
    learner.warmup(state, batch_size=learner_batch, unroll=unroll, obs_shape=(obs_dim,))
    wire = transport != "inproc"
    # a spawned actor host steps its lanes on its own CPU: it opens no CUDA
    # context, and a partial pickles where a lambda does not
    env_factory = functools.partial(CatchEnv, device="cpu" if wire else dev)
    common = dict(env_factory=env_factory, num_actors=actors, unroll=unroll,
                  envs_per_actor=envs_per_actor, algo="vtrace", train_step=learner.train_step,
                  state=state, learner_batch=learner_batch, max_param_lag=max_param_lag)
    policy = None
    if backend == "device":
        system = SeedSystem(backend="device", policy_apply=learner.device_policy_apply(),
                            **common)
    else:
        policy = learner.sampling_policy(params, seed=seed)
        for lanes in sorted({envs_per_actor, actors * envs_per_actor}):
            policy(np.zeros((lanes, obs_dim), np.float32), None)
        system = SeedSystem(policy_step=policy, deadline_ms=DEADLINE_MS,
                            policy_publish=policy.publish, transport=transport,
                            num_actor_hosts=actor_hosts, num_gateways=gateways, **common)
    return VTraceRun(dev, system, learner, policy, torch.backends.cuda.matmul.allow_tf32)


def check(stats):
    """Raise unless the run trained without an error and its frame ledger
    is conserved and settled: generated == trained + dropped, none
    pending."""
    if stats["learner_error"]:
        raise RuntimeError(f"learner died:\n{stats['learner_error']}")
    if stats["inference_error"]:
        raise RuntimeError(f"inference died:\n{stats['inference_error']}")
    if stats.get("host_errors"):
        raise RuntimeError(f"actor hosts died:\n{stats['host_errors']}")
    onp = stats["onpolicy"]
    if onp["frames_generated"] != onp["frames_trained"] + onp["frames_dropped"] \
            or onp["frames_pending"] != 0:
        raise RuntimeError(f"frame ledger not conserved: {onp}")
    if not (stats["env_frames"] > 0 and stats["learner_steps"] > 0):
        raise RuntimeError(f"no frames or no learner steps: {stats}")


def fig3f_row(actors, stats) -> dict:
    """The reference's Fig-3f row for one actor count."""
    onp = stats["onpolicy"]
    return {"actors": actors, "gen_frames_per_s": stats["env_frames_per_s"],
            "trained_frames_per_s": onp["frames_trained"] / stats["elapsed_s"],
            "drop_rate": onp["drop_rate"], "mean_param_lag": stats["mean_param_lag"],
            "mean_trained_lag": onp["mean_trained_lag"],
            "learner_steps": stats["learner_steps"]}


def run_point(actors, seconds, **kw):
    """Build one sweep point, warm its envs, run it for `seconds` and check
    it; returns (run, stats)."""
    run = build(actors, **kw)
    run.system.warmup()
    stats = run.system.run(seconds=seconds)
    check(stats)
    return run, stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--actors", type=int, nargs="+", default=[1, 2, 4],
                    help="actor counts to sweep")
    ap.add_argument("--envs-per-actor", type=int, default=4)
    ap.add_argument("--unroll", type=int, default=8)
    ap.add_argument("--learner-batch", type=int, default=4)
    ap.add_argument("--max-param-lag", type=int, default=None,
                    help="default 50 on the host backend, 10 on the device backend")
    ap.add_argument("--seconds", type=float, default=1.2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises where there is no card) or cpu")
    ap.add_argument("--backend", choices=("host", "device"), default="host",
                    help="host: actors + central inference; device: fused unrolls")
    ap.add_argument("--transport", choices=("inproc", "socket", "shm"), default="inproc",
                    help="host backend: actor threads here, or actor host processes")
    ap.add_argument("--actor-hosts", type=int, default=1,
                    help="actor host processes a point (socket/shm), at most its actors")
    ap.add_argument("--gateways", type=int, default=1,
                    help="inference gateways the hosts hash across (socket/shm)")
    args = ap.parse_args(argv)

    lag = MAX_PARAM_LAG[args.backend] if args.max_param_lag is None else args.max_param_lag
    kw = dict(envs_per_actor=args.envs_per_actor, unroll=args.unroll,
              learner_batch=args.learner_batch, max_param_lag=lag,
              device=args.device, seed=args.seed, backend=args.backend)
    print(f"== SEED V-trace (fig3f), {args.backend} backend: actors {args.actors} x "
          f"{args.envs_per_actor} Catch lanes, unroll {args.unroll}, learner batch "
          f"{args.learner_batch}, max_param_lag {lag}, {args.seconds}s a point, on "
          f"{resolve(args.device)}, transport {args.transport}")
    rows = []
    for n in args.actors:
        run, stats = run_point(n, args.seconds, transport=args.transport,
                               actor_hosts=min(args.actor_hosts, n), gateways=args.gateways,
                               **kw)
        row = fig3f_row(n, stats)
        rows.append(row)
        print(f"fig3f_vtrace_actors_{n},{row['gen_frames_per_s']:.1f},gen_frames_per_s "
              f"trained_per_s={row['trained_frames_per_s']:.1f} "
              f"drop_rate={row['drop_rate']:.2f} mean_param_lag={row['mean_param_lag']:.2f} "
              f"trained_lag={row['mean_trained_lag']:.2f} learner_steps={row['learner_steps']} "
              f"(TF32 {run.tf32})")
    print("ok — frame ledger conserved at every point: generated == trained + dropped")
    return rows


if __name__ == "__main__":
    main()
