"""The paper's exact workload, end to end: SEED-style distributed R2D2 on
an ALE stand-in, on the card.

The port's counterpart of ``examples/train_atari_r2d2.py``, with the same
flags plus ``--device`` (default cuda; raises where there is no card), the
same reduced config and the same printed stats and final ``ok``. Actor
threads step the env and query the central inference server, which owns
each lane's LSTM state (SEED-style); unrolls land in prioritized replay;
the learner runs recurrent double-Q with burn-in and publishes fresh
params. Reports the Fig-3 quantities (frames/s, batch occupancy).

    PYTHONPATH=src python -m repro_torch.launch.train_r2d2 --device cpu \\
        --actors 2 --envs-per-actor 2 --seconds 8 [--transport shm --actor-hosts 2]

With ``--transport socket`` or ``shm`` the actors run in ``--actor-hosts``
spawned processes that step their envs on the host and dial
``--gateways`` inference gateways in this process; the learner and the
inference server stay here, on the card.

The wiring lives in `build`, which ``chip_smoke.py`` drives at the full
R2D2 widths:
- the per-slot LSTM state, kept on the device and indexed by the server's
  dense (actor, lane) slot ids;
- epsilon-greedy from an explicit ``numpy.random.Generator``;
- the replay batch moved to the device, obs as uint8 (scaled on the card);
- the published-params seam (`PublishedParams`): the port's train step
  updates the params in place, where JAX arrays are immutable, so
  inference reads its own copy, which a publish overwrites under a lock
  that each inference batch holds across its forward's launches: a batch
  computes with one version of the params.
TF32 is turned off for cuDNN's convolutions and cuBLAS's products on the
card: the agent is fp32, as the reference's ``jnp.float32`` params are.
"""

import argparse
import copy
import functools
import threading
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.r2d2_atari import AtariConfig
from repro_torch.core.losses import init_train_state, make_train_step
from repro_torch.core.system import SeedSystem
from repro_torch.device import resolve
from repro_torch.envs.alesim import ALESimEnv
from repro_torch.models.atari import make_atari
from repro_torch.nn.recurrent import lstm_state_init
from repro_torch.optim import adamw

# the example's learning rate, exploration rate and inference deadline
LR = 5e-4
EPS = 0.2
DEADLINE_MS = 4.0


class PublishedParams:
    """The inference copy of the learner's params: a module of its own
    (never an alias of the trained one), overwritten by `publish` under
    `lock`. A reader holds `lock` while it launches the work that reads
    the params; on one stream, that work then runs wholly before or wholly
    after a publish's copies."""

    def __init__(self, params):
        self.params = copy.deepcopy(params).requires_grad_(False)
        self.version = 0
        self.lock = threading.Lock()

    @torch.no_grad()
    def publish(self, params, step):
        with self.lock:
            for dst, src in zip(self.params.parameters(), params.parameters()):
                dst.copy_(src)
            self.version = step


@dataclass
class R2D2Run:
    """What `build` wires: the system; the inference side's params, its
    per-slot LSTM state ({"h", "c"}, each (slots, core_dim)) and the
    ``policy_step(obs, slot_ids) -> actions`` the server calls; the TF32
    flags the run computes under."""
    device: torch.device
    system: SeedSystem
    published: PublishedParams
    core: dict
    policy_step: Callable
    tf32: dict


def device_batch(batch, device, core_dim):
    """A replay batch on `device`, as the example's learner feeds it: obs
    as uint8 (as stored), actions as int64, rewards and dones as fp32, the
    LSTM starting from zeros. The importance weights stay behind, as the
    example leaves them: the reference's weighted loss has no gradient
    (ROADMAP section 3)."""
    b = batch["obs"].shape[0]
    return {
        "obs": torch.from_numpy(batch["obs"]).to(device),
        "actions": torch.from_numpy(np.asarray(batch["actions"], np.int64)).to(device),
        "rewards": torch.from_numpy(np.asarray(batch["rewards"], np.float32)).to(device),
        "dones": torch.from_numpy(np.asarray(batch["dones"], np.float32)).to(device),
        "core": lstm_state_init(b, core_dim, device=device),
    }


def build(acfg, *, actors=2, envs_per_actor=1, device="cuda", env_factory=None,
          learner_batch=2, replay_capacity=256, transport="inproc", actor_hosts=1,
          gateways=1, telemetry=None, ops_port=None) -> R2D2Run:
    """The SEED R2D2 system of `acfg` on `device`, as the example wires it:
    AdamW, a target net (params from seed 0), `actors` x `envs_per_actor`
    lanes of `env_factory` (default: the example's ALESimEnv at the
    config's frame, step_cost 512, episode_len 200, as a picklable
    partial), and one warm-up inference batch and train step (on zeros)
    before the system is made, so that a measured window starts warm. The
    learner starts once replay holds one batch of sequences. `transport`
    "socket" or "shm" moves the actors into `actor_hosts` spawned
    processes behind `gateways` gateways (`env_factory` must pickle).
    `telemetry` and `ops_port` go to `SeedSystem` as they are."""
    dev = resolve(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if env_factory is None:
        env_factory = functools.partial(ALESimEnv, frame=acfg.obs_size,
                                        channels=acfg.obs_channels, step_cost=512,
                                        episode_len=200)
    bundle = make_atari(acfg)
    opt = adamw(LR)
    state = init_train_state(bundle, opt, 0, dev, with_target=True)
    train_step = make_train_step(bundle, opt, algo="r2d2", acfg=acfg)
    published = PublishedParams(state["params"])

    # central inference owns per-LANE LSTM state (SEED's key design): the
    # server hands policy_step dense (actor, env) slot ids
    n_slots = max(64, actors * envs_per_actor)
    core = {k: torch.zeros((n_slots, acfg.core_dim), device=dev) for k in ("h", "c")}
    rng = np.random.default_rng(0)

    def policy_step(obs, ids):
        ids_t = torch.as_tensor(ids, device=dev)
        obs_t = torch.as_tensor(obs, device=dev)
        with published.lock, torch.no_grad():
            explore = rng.random(len(ids)) < EPS
            random_a = rng.integers(0, acfg.num_actions, len(ids))
            q, (h, c) = bundle.decode_step(published.params, obs_t,
                                           (core["h"][ids_t], core["c"][ids_t]))
            core["h"][ids_t] = h
            core["c"][ids_t] = c
            a = torch.argmax(q, dim=-1)
        return np.where(explore, random_a, a.cpu().numpy())

    def train_on(st, batch):
        return train_step(st, device_batch(batch, dev, acfg.core_dim))

    lanes = actors * envs_per_actor
    frame = (acfg.obs_size, acfg.obs_size, acfg.obs_channels)
    policy_step(np.zeros((lanes,) + frame, np.uint8), np.arange(lanes))
    seq_len = acfg.burn_in + acfg.unroll
    dummy = {"obs": np.zeros((learner_batch, seq_len) + frame, np.uint8),
             "actions": np.zeros((learner_batch, seq_len), np.int32),
             "rewards": np.zeros((learner_batch, seq_len), np.float32),
             "dones": np.zeros((learner_batch, seq_len), np.float32)}
    state, _ = train_on(state, dummy)
    published.publish(state["params"], state["step"])

    system = SeedSystem(
        env_factory=env_factory, policy_step=policy_step, num_actors=actors,
        unroll=seq_len, envs_per_actor=envs_per_actor, train_step=train_on, state=state,
        learner_batch=learner_batch, replay_capacity=replay_capacity, min_replay=learner_batch,
        deadline_ms=DEADLINE_MS, policy_publish=published.publish, transport=transport,
        num_actor_hosts=actor_hosts, num_gateways=gateways, telemetry=telemetry,
        ops_port=ops_port)
    tf32 = {"matmul": torch.backends.cuda.matmul.allow_tf32,
            "cudnn": torch.backends.cudnn.allow_tf32}
    return R2D2Run(dev, system, published, core, policy_step, tf32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--actors", type=int, default=2)
    ap.add_argument("--envs-per-actor", type=int, default=1,
                    help="env lanes vectorized per actor thread")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--frame", type=int, default=42)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises where there is no card) or cpu")
    ap.add_argument("--transport", choices=("inproc", "socket", "shm"), default="inproc",
                    help="inproc: actor threads here; socket/shm: actor host processes")
    ap.add_argument("--actor-hosts", type=int, default=1,
                    help="actor host processes (socket/shm)")
    ap.add_argument("--gateways", type=int, default=1,
                    help="inference gateways the hosts hash across (socket/shm)")
    args = ap.parse_args(argv)

    acfg = AtariConfig(obs_size=args.frame, obs_channels=2, core_dim=128,
                       num_actions=6, burn_in=4, unroll=16, n_step=3,
                       target_update_period=50)
    run = build(acfg, actors=args.actors, envs_per_actor=args.envs_per_actor,
                device=args.device, transport=args.transport, actor_hosts=args.actor_hosts,
                gateways=args.gateways)
    print(f"== SEED R2D2: {args.actors} actors x {args.envs_per_actor} env "
          f"lanes, {args.seconds}s wall-clock, on {run.device} (TF32 {run.tf32}), "
          f"transport {args.transport}")
    stats = run.system.run(seconds=args.seconds)
    for k, v in stats.items():
        print(f"  {k:24s} {v:.3f}" if isinstance(v, float) else f"  {k:24s} {v}")
    if stats["learner_error"]:
        raise SystemExit(f"learner died:\n{stats['learner_error']}")
    if stats["inference_error"]:
        raise SystemExit(f"inference died:\n{stats['inference_error']}")
    if stats.get("host_errors"):
        raise SystemExit(f"actor hosts died:\n{stats['host_errors']}")
    if not (stats["env_frames"] > 0 and stats["learner_steps"] > 0):
        raise SystemExit(f"no frames or no learner steps: {stats}")
    print("ok — actors, central inference, replay and learner all ran")
    return run, stats


if __name__ == "__main__":
    main()
