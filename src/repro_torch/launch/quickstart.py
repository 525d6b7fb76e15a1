"""Quickstart: the whole stack in one run, on the card.

The port's counterpart of ``examples/quickstart.py``, in the same steps:

1. builds a reduced LM policy (``--arch``, default qwen3-14b's family),
2. trains it with the V-trace learner on synthetic trajectories,
3. checkpoints, restores, and serves a few greedy tokens (steps 1-3 are
   ``lm_demo``, which runs alone too),
4. runs the SEED actor/inference system with vector env lanes and shows
   the envs-per-actor throughput axis, then the device-resident backend
   and actors in a spawned host over TCP and over shared-memory rings,
   and the sharded inference plane (replicas x gateways, engine shards),
5. trains on-policy (``algo="vtrace"``, the trajectory queue) on the host
   and the device backend,
6. re-runs the system under the telemetry plane and prints the measured
   BottleneckReport, then scrapes the live ops plane over HTTP,
7. crashes the learner with a `ChaosMonkey` mid-training and brings the
   run back via `SeedSystem.resume()` from the live-loop checkpoints.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--arch ARCH] [--device cpu]

It runs on the card unless ``--device cpu`` is given (and raises where
there is no card). Catch lanes step on the run's device in process and on
the CPU in a spawned actor host, which opens no CUDA context. Files go
under ``--out-dir`` (``build/quickstart/`` in the checkout by default).
"""

import argparse
import functools
import json
import shutil
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import make_model, smoke_config
from repro_torch.core.losses import init_train_state, make_train_step
from repro_torch.core.system import SeedSystem
from repro_torch.device import resolve
from repro_torch.envs.catch import CatchEnv
from repro_torch.envs.tokenworld import synthetic_vtrace_batch
from repro_torch.launch import train_vtrace
from repro_torch.launch.rollout_backends import device_policy
from repro_torch.launch.serve import greedy_generate
from repro_torch.optim import adamw

ROOT = Path(__file__).resolve().parents[3]
DEFAULT_OUT_DIR = ROOT / "build" / "quickstart"


def _quickstart_policy(obs, ids):
    # module-level (not a closure): the socket transport's spawned actor
    # hosts never see it, but the env_factory they DO receive must pickle
    return np.random.randint(0, 3, size=(obs.shape[0],))


def lm_demo(arch="qwen3-14b", *, device="cuda", out_dir=DEFAULT_OUT_DIR, steps=20, log=print):
    """Steps 1-3: the reduced `arch` trained with V-trace for `steps` steps
    on synthetic batches (4 x 32 tokens), checkpointed and restored, then 8
    greedy tokens from two all-zero prompts. Returns {"losses", "restored_step",
    "generated" (2, 8) int32}."""
    dev = resolve(device)
    cfg = smoke_config(arch)
    bundle = make_model(cfg)
    opt = adamw(1e-3)
    step = make_train_step(bundle, opt)
    state = init_train_state(bundle, opt, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    log(f"== training reduced {arch} with V-trace for {steps} steps on {dev}")
    losses = []
    for i in range(steps):
        state, metrics = step(state, synthetic_vtrace_batch(gen, 4, 32, cfg.vocab_size))
        losses.append(float(metrics["loss"]))
        if (i + 1) % 5 == 0:
            log(f"  step {i + 1:3d} loss={losses[-1]:.4f} pg={float(metrics['pg_loss']):.4f} "
                f"grad_norm={float(metrics['grad_norm']):.2f}")

    log("== checkpoint round-trip")
    ckpt_dir = Path(out_dir) / "lm_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    mgr = CheckpointManager(str(ckpt_dir), async_save=False)
    mgr.save(state, steps)
    state, restored_step = mgr.restore(state)
    log(f"  restored step {restored_step}")

    log("== greedy decode 8 tokens from the trained policy")
    toks = torch.zeros((2, 8), dtype=torch.int32, device=dev)
    out = greedy_generate(bundle, state["params"], {"tokens": toks}, steps=8, max_len=32,
                          dtype=torch.float32)
    log(f"  generated: {out.tolist()}")
    return {"losses": losses, "restored_step": restored_step, "generated": out.cpu()}


def vector_actor_demo(device, env_counts=(1, 8), seconds=0.6):
    """SEED system over Catch lanes batched on `device`: each actor steps E
    lanes per inference round-trip; frames/s grows with E on the same
    threads. The device backend then runs env and policy as one unroll on
    the device (one CUDA graph replay on the card), removing the per-step
    round-trip. Then the actors move to a spawned host over TCP and over
    shared-memory rings."""
    catch = functools.partial(CatchEnv, device=device)
    for e in env_counts:
        system = SeedSystem(env_factory=catch, policy_step=_quickstart_policy, num_actors=2,
                            unroll=8, envs_per_actor=e, deadline_ms=2.0)
        system.warmup()
        stats = system.run(seconds=seconds, with_learner=False)
        assert stats["env_frames"] == stats["actor_iterations"] * e
        print(f"  E={e}: {stats['env_frames_per_s']:8.0f} env-frames/s "
            f"({stats['actor_iterations']} iterations x {e} lanes)")

    e = env_counts[-1]
    system = SeedSystem(env_factory=catch, backend="device",
                        policy_apply=device_policy(CatchEnv.num_actions), num_actors=2, unroll=8,
                        envs_per_actor=e)
    system.warmup()
    stats = system.run(seconds=seconds, with_learner=False)
    print(f"  E={e} device-resident: {stats['env_frames_per_s']:8.0f} env-frames/s "
        f"({stats['scans']} unrolls x 8 steps x {e} lanes)")

    # disaggregated: actors in a SEPARATE OS process dialing a loopback TCP
    # gateway, their lanes on that process's CPU
    cpu_catch = functools.partial(CatchEnv, device="cpu")
    system = SeedSystem(env_factory=cpu_catch, policy_step=_quickstart_policy, num_actors=2,
                        unroll=8, envs_per_actor=e, deadline_ms=1.0, transport="socket",
                        num_actor_hosts=1)
    stats = system.run(seconds=max(seconds, 0.8), with_learner=False)
    print(f"  E={e} socket-transport: {stats['env_frames_per_s']:8.0f} env-frames/s "
        f"({stats['gateway_connections']} actor-host conns, "
        f"{stats['gateway_traj_frames']} unrolls over the wire)")

    # co-located hosts skip the TCP hot path: each connection rides a
    # shared-memory ring pair, the socket kept as spill and liveness channel
    system = SeedSystem(env_factory=cpu_catch, policy_step=_quickstart_policy, num_actors=2,
                        unroll=8, envs_per_actor=e, deadline_ms=1.0, transport="shm",
                        num_actor_hosts=1)
    stats = system.run(seconds=max(seconds, 0.8), with_learner=False)
    print(f"  E={e} shm-transport:    {stats['env_frames_per_s']:8.0f} env-frames/s "
        f"({stats['host_shm_frames']} ring frames, {stats['host_spill_frames']} TCP spills, "
        f"{stats['gateway_shm_conns']} ring conns)")


def sharded_inference_demo(device, e=8, seconds=0.8):
    """The inference plane sharded: `num_replicas` policy workers behind
    `num_gateways` accept loops for two actor hosts; then the device path
    sharded the other way, `engine_shards` rollout engines."""
    system = SeedSystem(env_factory=functools.partial(CatchEnv, device="cpu"),
                        policy_step=_quickstart_policy, num_actors=2, unroll=8,
                        envs_per_actor=e, deadline_ms=1.0, transport="socket",
                        num_actor_hosts=2, num_gateways=2, num_replicas=2)
    stats = system.run(seconds=seconds, with_learner=False)
    print(f"  E={e} sharded ({stats['num_replicas']} replicas x {stats['num_gateways']} "
        f"gateways): {stats['env_frames_per_s']:8.0f} env-frames/s "
        f"(conns/gateway={stats['per_gateway_connections']}, "
        f"lanes/replica={stats['replica_lanes']})")

    system = SeedSystem(env_factory=functools.partial(CatchEnv, device=device),
                        backend="device", policy_apply=device_policy(CatchEnv.num_actions),
                        num_actors=2, unroll=8, envs_per_actor=e, engine_shards=2)
    system.warmup()
    stats = system.run(seconds=seconds, with_learner=False)
    print(f"  E={e} engine-sharded device (K={stats['engine_shards']}): "
        f"{stats['env_frames_per_s']:8.0f} env-frames/s ({stats['scans']} sharded unrolls)")


def onpolicy_demo(device, e=4, seconds=2.0):
    """The on-policy training plane: ``SeedSystem(algo="vtrace")`` through
    ``launch.train_vtrace.build``, on the host backend (the server samples
    actions and their logprobs; the learner publishes back) and on the
    device backend (the logprobs ride the unroll; the bounded queue drops
    what the learner cannot absorb). The frame ledger is conserved."""
    for backend in ("host", "device"):
        run = train_vtrace.build(2, envs_per_actor=e, device=device, backend=backend)
        run.system.warmup()
        stats = run.system.run(seconds=seconds)
        onp = stats["onpolicy"]
        assert onp["frames_generated"] == (onp["frames_trained"] + onp["frames_dropped"]
                                           + onp["frames_pending"])
        print(f"  {backend:6s} vtrace: {stats['env_frames_per_s']:7.0f} gen-frames/s, "
            f"{stats['learner_steps']} learner steps, drop_rate={onp['drop_rate']:.2f}, "
            f"mean_param_lag={stats['mean_param_lag']:.2f}")


def telemetry_demo(device, out_dir, e=4, seconds=1.0):
    """The measurement plane: the system under a `Telemetry` bundle, ending
    in which plane gates throughput and the measured CPU/GPU ratio;
    `dump()` writes trace.json and metrics.jsonl."""
    from repro_torch.telemetry import Telemetry

    tel = Telemetry(process_name="learner", out_dir=str(Path(out_dir) / "telemetry"))
    system = SeedSystem(env_factory=functools.partial(CatchEnv, device=device),
                        policy_step=_quickstart_policy, num_actors=2, unroll=8,
                        envs_per_actor=e, deadline_ms=2.0, telemetry=tel)
    system.warmup()
    stats = system.run(seconds=seconds, with_learner=False)
    for line in str(tel.bottleneck_report(stats)).splitlines():
        print(f"  {line}")
    rtt = tel.merged_histogram("wire/rtt_s")
    print(f"  inference rtt p50={rtt['p50'] * 1e6:.0f}us p99={rtt['p99'] * 1e6:.0f}us over "
        f"{rtt['count']} round-trips")
    paths = tel.dump()
    print(f"  wrote {paths['trace']} (open at ui.perfetto.dev) and {paths['metrics']}")


def ops_demo(device, out_dir, e=4, seconds=2.0):
    """The live ops plane: ``SeedSystem(ops_port=0)`` binds a loopback HTTP
    server; /metrics and /varz are scraped mid-run with urllib."""
    from repro_torch.telemetry import Telemetry

    tel = Telemetry(process_name="learner", out_dir=str(Path(out_dir) / "telemetry"))
    system = SeedSystem(env_factory=functools.partial(CatchEnv, device=device),
                        policy_step=_quickstart_policy, num_actors=2, unroll=8,
                        envs_per_actor=e, deadline_ms=2.0, telemetry=tel, ops_port=0)
    host, port = system.ops_address
    print(f"  ops plane listening on http://{host}:{port}")
    try:
        system.warmup()
        runner = threading.Thread(
            target=lambda: system.run(seconds=seconds, with_learner=False), daemon=True)
        runner.start()
        time.sleep(seconds / 2)                      # scrape MID-run
        with urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=5) as resp:
            metrics_text = resp.read().decode()
        with urllib.request.urlopen(f"http://{host}:{port}/varz", timeout=5) as resp:
            varz = json.load(resp)
        runner.join()
    finally:
        system.stop_ops()
    sample = [ln for ln in metrics_text.splitlines()
              if ln.startswith("inference_") and not ln.startswith("# ")]
    print(f"  /metrics: {len(metrics_text.splitlines())} lines, e.g. "
        f"{sample[0] if sample else '(warming up)'}")
    bn = varz.get("bottleneck", {})
    print(f"  /varz live bottleneck: {bn.get('bottleneck', '?')} "
        f"(cpu/gpu ratio {bn.get('cpu_gpu_ratio', 0.0):.2f})")
    print(f"  /healthz verdict: {varz.get('health', {}).get('verdict', '?')}")


def chaos_demo(device, out_dir, e=4, seconds=1.5):
    """The survival plane: a `ChaosMonkey` crashes the learner thread
    mid-V-trace-training, the live-loop checkpointer has been saving {params,
    opt_state, step}, and `SeedSystem.resume()` restores the latest step and
    the run continues with the frame ledger conserved across the crash."""
    from repro_torch.fault import ChaosEvent, ChaosMonkey
    from repro_torch.onpolicy import VTraceLearner, mlp_actor_critic

    catch = functools.partial(CatchEnv, device=device)
    obs_dim = int(np.prod(catch().obs_shape))
    init_fn, apply_fn = mlp_actor_critic(obs_dim, CatchEnv.num_actions)
    vl = VTraceLearner(apply_fn, adamw(1e-3))
    state = vl.init_state(init_fn(torch.Generator().manual_seed(0), device))
    vl.warmup(state, batch_size=4, unroll=8, obs_shape=(obs_dim,))
    policy = vl.sampling_policy(state["params"])
    for lanes in (e, 2 * e):                 # the server batches 1 or 2 actors
        policy(np.zeros((lanes, obs_dim), np.float32), None)
    ckpt_dir = Path(out_dir) / "chaos_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    system = SeedSystem(env_factory=catch, policy_step=policy, num_actors=2, unroll=8,
                        envs_per_actor=e, deadline_ms=1.0, algo="vtrace",
                        train_step=vl.train_step, state=state, learner_batch=4,
                        max_param_lag=50, policy_publish=policy.publish,
                        checkpoint_dir=str(ckpt_dir), checkpoint_every_s=0.3)
    system.warmup()      # the crash must land in a window that is training
    monkey = ChaosMonkey.scripted(ChaosEvent(0.6, "crash_learner_step"))
    monkey.start(system)
    stats = system.run(seconds=seconds)
    monkey.stop()
    err = (stats["learner_error"] or "crash missed the window").splitlines()
    print(f"  chaos: learner crashed after {stats['learner_steps']} steps ({err[-1]})")
    version = system.resume()
    rec = system._recovery_stats()
    print(f"  resume: restored from checkpoint, republished params at version {version} "
        f"(saves={rec['checkpoint_saves']}, restores={rec['checkpoint_restores']})")
    stats = system.run(seconds=seconds / 2)
    onp = stats["onpolicy"]
    assert onp["frames_generated"] == (onp["frames_trained"] + onp["frames_dropped"]
                                       + onp["frames_pending"])
    print(f"  after resume: {stats['learner_steps']} learner steps (> {version}), ledger "
        f"conserved across the crash (generated={onp['frames_generated']} == trained + "
        "dropped + pending)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises where there is no card) or cpu")
    ap.add_argument("--out-dir", default=str(DEFAULT_OUT_DIR))
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    out = lm_demo(args.arch, device=dev, out_dir=args.out_dir)
    print("== vectorized SEED actors (Catch lanes batched on the device)")
    vector_actor_demo(dev)
    print("== sharded inference plane (replicas x gateways, engine shards)")
    sharded_inference_demo(dev)
    print("== on-policy training plane (algo='vtrace', trajectory queue)")
    onpolicy_demo(dev)
    print("== telemetry plane (spans, histograms, bottleneck attribution)")
    telemetry_demo(dev, args.out_dir)
    print("== live ops plane (/metrics, /healthz, /varz over HTTP)")
    ops_demo(dev, args.out_dir)
    print("== survival plane (chaos-injected learner crash + resume)")
    chaos_demo(dev, args.out_dir)
    print("ok")
    return out


if __name__ == "__main__":
    main()
