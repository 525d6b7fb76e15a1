"""Fig 3 on the card: the actor-count sweep, the envs-per-actor axis, the
rollout design points, sharded inference and the on-policy ledger.

The port's counterpart of ``benchmarks/fig3_actor_scaling.py``, printing
its ``name,value,derived`` rows under the same names:
  (a) MEASURED: `SeedSystem` on `ALESimEnv(frame=32)` (numpy, on the
      host's CPU) with a random numpy policy on the host, swept over actor
      counts; this part does not touch the card, as the reference's does
      not touch its accelerator.
  (b) MODEL: the calibrated actor/learner model at paper scale (40 host
      threads), held to the paper's 5.8x (4->40) and 2.0x (40->256).
  (c) ENV VECTORIZATION: (a) at 2 actors over E lanes an actor, and the
      model along E.
  (d) DESIGN POINTS: per-step host, vectorized host and device-resident on
      Catch batched on `device` (`launch/rollout_backends.py`), the model
      at the reference's guessed device costs, and beside it the model at
      the card's measured `t_dev0` and `t_dev1` (`measure_t_dev`), in
      units of t_env, the median of five trials of a 1-lane Catch step as
      the per-step host point takes it: the one input this card changes
      in the paper's model.
  (e) SHARDED INFERENCE: Catch on `device`, a sleeping numpy policy on the
      host behind R replicas; engine shards of the device backend; the
      `with_sharded` model.
  (f) ALGORITHM AXIS (``--algo vtrace``): `launch/train_vtrace.py`'s
      Fig-3f points (Catch and the MLP on `device`), and the
      `onpolicy_point` model.

Beside each measured row's frames/s it prints the learner's train and
wait seconds ("none" where the point runs no learner) and the inference
server's compute seconds (0 on the device backend, which has no server):
the learner, the server and the actor threads share one interpreter, so
frames/s alone measures that interpreter, not the CPU/GPU ratio.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig3_actor_scaling \\
        [--smoke] [--replicas N] [--algo r2d2|vtrace] [--device cuda|cpu]

Without ``--device cpu`` it runs on the card and raises where there is
none. The reference's ``--telemetry``, ``--chaos`` and ``--autoscale``
parts need the ops and survival planes, which are not ported: they exit
naming the ROADMAP item.
"""

import argparse
import functools
import math
import time

import numpy as np
import torch

from repro_torch.benchmarks.fig4_cpu_gpu_ratio import catch_policy
from repro_torch.benchmarks.timing import device_ms
from repro_torch.core.provisioning import fit_paper_actor_model
from repro_torch.core.system import SeedSystem
from repro_torch.device import resolve
from repro_torch.envs.alesim import ALESimEnv
from repro_torch.envs.catch import CatchEnv
from repro_torch.hw import V100
from repro_torch.launch import rollout_backends, train_vtrace
from repro_torch.launch.actor_host import OPS_ITEM

# Fig 3f's point (benchmarks/fig3_actor_scaling.py:220-221)
VTRACE = dict(envs_per_actor=4, unroll=8, learner_batch=4, max_param_lag=50)
# the engine widths and unroll of the t_dev fit (chip_smoke.py phase 16)
T_DEV_LANES = (8, 64, 512, 4096)
T_DEV_UNROLL = 16
T_ENV_TRIALS = 5


def numpy_policy(num_actions, seed=0):
    """A uniform random host policy from its own generator."""
    rng = np.random.default_rng(seed)

    def policy_step(obs, ids):
        return rng.integers(0, num_actions, size=(obs.shape[0],))
    return policy_step


def busy_policy(obs, ids):
    """Part (e)'s latency-bound forward: a sleep that releases the
    interpreter lock (the host's view of a device forward), then Fig 4's
    deterministic action from the obs."""
    time.sleep(0.005)
    return catch_policy(obs, ids)


def measured_row(system, stats, **labels) -> dict:
    """A measured point's row: frames/s and what explains it, with the
    learner's train and wait seconds (None without a learner) and the
    server's compute seconds."""
    learner = system.learner
    row = dict(labels)
    row.update({k: stats[k] for k in ("env_frames_per_s", "env_frames", "actor_iterations",
                                      "mean_batch_occupancy", "mean_queue_wait_ms",
                                      "inference_compute_s", "inference_error")})
    row.update(learner_train_s=learner.train_time_s if learner else None,
               learner_wait_s=learner.wait_time_s if learner else None)
    return row


def seconds_text(row) -> str:
    def s(x):
        return "none" if x is None else f"{x:.3f}"
    return (f"learner_train_s={s(row.get('learner_train_s'))} "
            f"learner_wait_s={s(row.get('learner_wait_s'))} "
            f"inference_compute_s={s(row.get('inference_compute_s', 0.0))}")


def measured_sweep(actor_counts=(1, 2, 4, 8), seconds=1.2, step_cost=2048, envs_per_actor=1):
    """Part (a): ALESimEnv(frame=32) lanes and a random numpy policy, both
    on the host; one row an actor count."""
    rows = []
    for n in actor_counts:
        system = SeedSystem(
            env_factory=functools.partial(ALESimEnv, frame=32, step_cost=step_cost),
            policy_step=numpy_policy(ALESimEnv.num_actions), num_actors=n, unroll=16,
            deadline_ms=2.0, envs_per_actor=envs_per_actor)
        stats = system.run(seconds=seconds, with_learner=False)
        rows.append(measured_row(system, stats, actors=n, envs_per_actor=envs_per_actor))
    return rows


def measured_env_sweep(env_counts=(1, 2, 4, 8), actors=2, seconds=1.2, step_cost=512):
    """Part (c): a fixed actor-thread count, E lanes an actor."""
    return [measured_sweep(actor_counts=(actors,), seconds=seconds, step_cost=step_cost,
                           envs_per_actor=E)[0] for E in env_counts]


def model_sweep():
    model, err = fit_paper_actor_model()
    counts = (4, 8, 16, 32, 40, 64, 128, 256)
    return model, err, [(n, float(model.speedup(n, 4))) for n in counts]


def fig3b_checks(sw):
    """(4->40 speedup, 40->256 speedup) of `model_sweep`'s rows: the
    paper's 5.8 and 2.0."""
    s = dict(sw)
    return s[40], s[256] / s[40]


def model_env_sweep(env_counts=(1, 2, 4, 8, 16), n_actors=40):
    """Calibrated model at paper scale along the second (E) axis."""
    model, _ = fit_paper_actor_model()
    base = float(model.throughput(n_actors))
    return [(E, float(model.with_envs(E).throughput(n_actors)) / base)
            for E in env_counts]


def measured_backend_sweep(seconds=1.0, unroll=16, device="cuda"):
    """Part (d): `rollout_backends`' three points, Catch on `device`."""
    rows = []
    for name, backend, lanes in rollout_backends.POINTS:
        system, stats = rollout_backends.run_point(backend, lanes, unroll=unroll,
                                                   seconds=seconds, device=device)
        rows.append(measured_row(system, stats, name=name, envs_per_actor=lanes))
    return rows


def model_backend_sweep(envs_per_actor=8, n_actors=40):
    """Part (d), model: the same three design points at paper scale."""
    model, _ = fit_paper_actor_model()
    return [
        ("per_step_host", float(model.throughput(n_actors))),
        ("vectorized_host",
         float(model.with_envs(envs_per_actor).throughput(n_actors))),
        ("device_resident",
         float(model.with_envs(envs_per_actor).with_device()
               .throughput(n_actors))),
    ]


def model_device_card(t_dev0, t_dev1, envs_per_actor=8, n_actors=40):
    """Part (d), the device point at costs measured on a card (t_env
    units): (frames per t_env, its factor over the vectorized host)."""
    model, _ = fit_paper_actor_model()
    m = model.with_envs(envs_per_actor)
    t = float(m.with_device(t_dev0, t_dev1).throughput(n_actors))
    return t, t / float(m.throughput(n_actors))


def catch_step_s(device, iters=200):
    """t_env on `device`: one Catch vector step at 1 lane alone, as the
    per-step host point of part (d) steps it (the copy to the host
    included), host clock. Returns (the median of T_ENV_TRIALS means of
    `iters` steps, those means), in seconds: a single trial moves with the
    host's scheduling."""
    from repro_torch.envs.vector import make_vector_env

    vec = make_vector_env(functools.partial(CatchEnv, device=device), 1, seed=0)
    vec.reset()
    zeros = np.zeros(1, np.int32)
    for _ in range(20):
        vec.step(zeros)
    means = []
    for _ in range(T_ENV_TRIALS):
        t0 = time.perf_counter()
        for _ in range(iters):
            vec.step(zeros)
        means.append((time.perf_counter() - t0) / iters)
    return float(np.median(means)), means


def fit_t_dev(lanes, replay_ms, unroll, t_env_s) -> dict:
    """`SystemModel.with_device`'s inputs from one engine's replays: a
    least-squares line through ms a replay / unroll = t_dev0 + t_dev1 * E,
    in seconds and in units of t_env."""
    lanes = np.asarray(lanes, np.float64)
    per_step_s = np.asarray(replay_ms, np.float64) / 1e3 / unroll
    t_dev1, t_dev0 = np.polyfit(lanes, per_step_s, 1)
    return {"t_dev0_s": float(t_dev0), "t_dev1_s": float(t_dev1), "t_env_s": t_env_s,
            "t_dev0_in_t_env": float(t_dev0 / t_env_s),
            "t_dev1_in_t_env": float(t_dev1 / t_env_s),
            "residual_max_s": float(np.abs(per_step_s - (t_dev0 + t_dev1 * lanes)).max())}


def measure_t_dev(device, lanes=T_DEV_LANES, unroll=T_DEV_UNROLL, iters=50, each=None) -> dict:
    """The replay sweep behind the card's Fig 3d row: one engine alone on
    Catch at each width in `lanes`, a uniform random policy, ms a replay
    by `timing.device_ms` (behind a sleeping kernel on the card, the host
    clock on the CPU); then `fit_t_dev` against `catch_step_s`'s median.
    `each(lanes, engine)`, where given, runs after a width's timing and
    returns more columns for that width's row. Returns the fit with
    `t_env_trials_s` and `sweep`, {width: {"replay_ms", "host_limited",
    ...}}."""
    from repro_torch.rollout import DeviceRolloutEngine

    dev = resolve(device)
    policy = rollout_backends.device_policy(CatchEnv.num_actions)
    t_env, trials = catch_step_s(dev)
    sweep = {}
    for e in lanes:
        eng = DeviceRolloutEngine(CatchEnv(device=dev), policy, e, unroll, seed=e)
        eng.warmup(None)
        ms, host_limited = device_ms(lambda: eng.dispatch(None), iters=iters, device=dev)
        sweep[e] = {"replay_ms": ms, "host_limited": host_limited}
        if each is not None:
            sweep[e].update(each(e, eng))
        del eng
    fit = fit_t_dev(lanes, [sweep[e]["replay_ms"] for e in lanes], unroll, t_env)
    fit.update(t_env_trials_s=trials, sweep=sweep)
    return fit


def measured_replica_sweep(replica_counts=(1, 2), num_actors=4, envs_per_actor=2, seconds=1.0,
                           unroll=8, device="cuda"):
    """Part (e): Catch batched on `device`, `busy_policy` on the host behind
    R data-parallel replicas. The forward is a sleep, so the one loop
    serializes the forwards and replicas overlap them."""
    dev = resolve(device)
    rows = []
    for R in replica_counts:
        system = SeedSystem(env_factory=functools.partial(CatchEnv, device=dev),
                            policy_step=busy_policy, num_actors=num_actors, unroll=unroll,
                            envs_per_actor=envs_per_actor, deadline_ms=1.0, num_replicas=R)
        system.warmup()
        stats = system.run(seconds=seconds, with_learner=False)
        row = measured_row(system, stats, replicas=R, envs_per_actor=envs_per_actor)
        row["replica_lanes"] = stats.get("replica_lanes", [stats["inference_lanes"]])
        rows.append(row)
    return rows


def measured_engine_shard_sweep(shard_counts=(1, 2), seconds=1.0, unroll=8, device="cuda"):
    """Part (e), device path: `rollout_backends`' engine shards, Catch on
    `device`, 8 lanes an actor."""
    rows = []
    for K in shard_counts:
        system, stats = rollout_backends.run_point("device", 8, unroll=unroll,
                                                   engine_shards=K, seconds=seconds,
                                                   device=device)
        rows.append(measured_row(system, stats, engine_shards=K, envs_per_actor=8))
    return rows


def model_replica_sweep(replica_counts=(1, 2, 4, 8), n_actors=40):
    """Part (e), model at paper scale: `with_sharded` — forward capacity
    xN until per-replica batch fill starves (t_inf0 floor). E=1, so the
    inference term is not already amortized away by lane vectorization."""
    model, _ = fit_paper_actor_model()
    base = float(model.throughput(n_actors))
    return [(R, float(model.with_sharded(R).throughput(n_actors)) / base)
            for R in replica_counts]


def measured_vtrace_sweep(actor_counts=(1, 2), seconds=1.2, device="cuda"):
    """Part (f): `train_vtrace.run_point` at each actor count (Catch, the
    MLP and the learner on `device`): the Fig-3f row and its seconds."""
    rows = []
    for n in actor_counts:
        run, stats = train_vtrace.run_point(n, seconds, device=device, **VTRACE)
        row = train_vtrace.fig3f_row(n, stats)
        row.update(measured_row(run.system, stats))
        rows.append(row)
    return rows


def model_vtrace_sweep(actor_counts=(4, 16, 40, 128, 256),
                       learner_step_s=8.0, batch_size=8, unroll=20):
    """Part (f), model at paper scale: `SystemModel.onpolicy_point` — the
    drop-rate/staleness knee as a function of actor count."""
    model, _ = fit_paper_actor_model()
    return [(n, model.onpolicy_point(n, learner_step_s=learner_step_s,
                                     batch_size=batch_size, unroll=unroll))
            for n in actor_counts]


def perf_per_watt(sw):
    """The paper's right axis: speedup per 100 W on the V100, power linear
    in utilization. (n, speedup per 100 W, power W) rows."""
    rows = []
    for n, s in sw:
        util = min(1.0, s / max(x for _, x in sw))
        power = V100.idle_power_w + (V100.peak_power_w - V100.idle_power_w) * util
        rows.append((n, s / power * 100, power))
    return rows


# -- the rows, as the reference prints them ----------------------------------

def lines_3a(rows):
    base = rows[0]["env_frames_per_s"]
    return [f"fig3a_actors_{r['actors']},{r['env_frames_per_s']:.1f},frames_per_s "
            f"speedup={r['env_frames_per_s'] / base:.2f} occupancy="
            f"{r['mean_batch_occupancy']:.2f} queue_wait_ms={r['mean_queue_wait_ms']:.2f} "
            f"{seconds_text(r)}" for r in rows]


def lines_3b():
    _, err, sw = model_sweep()
    out = [f"fig3b_speedup_{n},{s:.2f},relative_to_4_actors" for n, s in sw]
    s40, s256_40 = fig3b_checks(sw)
    out += [f"fig3b_check_4to40,{s40:.2f},paper=5.8 err={abs(s40 - 5.8) / 5.8:.1%}",
            f"fig3b_check_40to256,{s256_40:.2f},paper=2.0 "
            f"err={abs(s256_40 - 2.0) / 2.0:.1%}",
            f"fig3b_fit_residual,{err:.4f},rms"]
    return out


def lines_3c(rows):
    base = rows[0]["env_frames_per_s"] / rows[0]["actors"]
    out = []
    for r in rows:
        per_thread = r["env_frames_per_s"] / r["actors"]
        out.append(f"fig3c_envs_{r['envs_per_actor']},{r['env_frames_per_s']:.1f},frames_per_s "
                   f"per_thread={per_thread:.1f} per_thread_speedup={per_thread / base:.2f} "
                   f"occupancy={r['mean_batch_occupancy']:.2f} "
                   f"queue_wait_ms={r['mean_queue_wait_ms']:.2f} {seconds_text(r)}")
    return out


def lines_3c_model():
    return [f"fig3c_model_envs_{E},{s:.2f},throughput_vs_E1_at_40_actors"
            for E, s in model_env_sweep()]


def lines_3d(rows):
    base = rows[0]["env_frames_per_s"]
    out = [f"fig3d_{r['name']},{r['env_frames_per_s']:.1f},frames_per_s "
           f"E={r['envs_per_actor']} vs_per_step={r['env_frames_per_s'] / base:.2f}x "
           f"{seconds_text(r)}" for r in rows]
    fps = {r["name"]: r["env_frames_per_s"] for r in rows}
    if fps["device_resident"] <= fps["vectorized_host"]:
        out.append("fig3d_WARNING,0,device_resident did not beat vectorized_host")
    return out


def lines_3d_model(fit=None, device_name=None):
    """The model's three points at the reference's device defaults; with
    `fit` (`fit_t_dev`'s dict) one more row at the measured costs."""
    rows = model_backend_sweep()
    base = rows[0][1]
    out = [f"fig3d_model_{name},{t:.1f},frames_per_s_model vs_per_step={t / base:.2f}x"
           for name, t in rows]
    if fit is not None and fit["t_dev1_in_t_env"] <= 0:
        out.append(f"fig3d_model_device_resident_card,nan,t_dev1 fit {fit['t_dev1_s']:.3g} s "
                   f"not positive measured_on={device_name}")
    elif fit is not None:
        t, over = model_device_card(fit["t_dev0_in_t_env"], fit["t_dev1_in_t_env"])
        trials = fit.get("t_env_trials_s") or [fit["t_env_s"]]
        out.append(f"fig3d_model_device_resident_card,{t:.1f},frames_per_s_model "
                   f"vs_per_step={t / base:.2f}x vs_vectorized={over:.1f}x "
                   f"t_dev0={fit['t_dev0_s']:.4e}s ({fit['t_dev0_in_t_env']:.4g} t_env) "
                   f"t_dev1={fit['t_dev1_s']:.4e}s ({fit['t_dev1_in_t_env']:.4g} t_env) "
                   f"t_env={fit['t_env_s']:.4e}s (a 1-lane Catch step as the per-step host "
                   f"point takes it; median of {len(trials)} trials, {min(trials):.4e}-"
                   f"{max(trials):.4e} s) measured_on={device_name}")
    return out


def lines_3e(rows):
    base = max(rows[0]["env_frames_per_s"], 1e-9)
    return [f"fig3e_replicas_{r['replicas']},{r['env_frames_per_s']:.1f},frames_per_s "
            f"vs_single={r['env_frames_per_s'] / base:.2f}x "
            f"occupancy={r['mean_batch_occupancy']:.2f} replica_lanes={r['replica_lanes']} "
            f"{seconds_text(r)}" for r in rows]


def lines_3e_shards(rows):
    base = max(rows[0]["env_frames_per_s"], 1e-9)
    return [f"fig3e_engine_shards_{r['engine_shards']},{r['env_frames_per_s']:.1f},frames_per_s "
            f"vs_single={r['env_frames_per_s'] / base:.2f}x {seconds_text(r)}" for r in rows]


def lines_3e_model():
    return [f"fig3e_model_replicas_{R},{s:.2f},throughput_vs_1_replica"
            for R, s in model_replica_sweep()]


def lines_3f(rows):
    return [f"fig3f_vtrace_actors_{r['actors']},{r['gen_frames_per_s']:.1f},gen_frames_per_s "
            f"trained_per_s={r['trained_frames_per_s']:.1f} drop_rate={r['drop_rate']:.2f} "
            f"mean_param_lag={r['mean_param_lag']:.2f} "
            f"trained_lag={r['mean_trained_lag']:.2f} learner_steps={r['learner_steps']} "
            f"{seconds_text(r)}" for r in rows]


def lines_3f_model():
    return [f"fig3f_model_actors_{n},{p.drop_rate:.2f},drop_rate "
            f"trained_per_s={p.frames_trained_per_s:.1f} "
            f"mean_param_lag={p.mean_param_lag:.1f} learner_bound={p.learner_bound}"
            for n, p in model_vtrace_sweep()]


def lines_ppw():
    _, _, sw = model_sweep()
    return [f"fig3b_perf_per_watt_{n},{ppw:.3f},speedup_per_100W power={power:.0f}W"
            for n, ppw, power in perf_per_watt(sw)]


def report(rows, device_name, where) -> list:
    """The report's sections, [(title, lines)], from measured rows: with
    ``rows["a"]`` parts (a)-(e) (keys a, c, d, t_dev, e, shards) and the
    models beside them; with ``rows["f"]`` part (f) and its model.
    `device_name` names the card the t_dev fit ran on, `where` the device
    Catch ran on in (d) and (e)."""
    sections = []
    if "a" in rows:
        sections += [
            ("fig3a: measured actor sweep (ALESim and the random policy on the host)",
             lines_3a(rows["a"])),
            ("fig3b: calibrated model at paper scale (40 hw threads)", lines_3b()),
            ("fig3c: envs-per-actor sweep (measured, 2 actor threads, on the host)",
             lines_3c(rows["c"])),
            ("fig3c: model at paper scale (40 actors, E lanes each)", lines_3c_model()),
            (f"fig3d: design points at equal (num_actors, E) — measured, Catch on {where}",
             lines_3d(rows["d"])),
            ("fig3d: model at paper scale (40 actors x 8 lanes); the last row at the "
             "measured t_dev", lines_3d_model(rows["t_dev"], device_name)),
            (f"fig3e: sharded inference — measured replica sweep (Catch on {where}, a "
             "sleeping policy on the host)", lines_3e(rows["e"])),
            ("fig3e: engine-sharded device scans (measured)", lines_3e_shards(rows["shards"])),
            ("fig3e: with_sharded model at paper scale (40 actors, E=1)", lines_3e_model()),
            ("fig3b: perf per watt, V100 power model", lines_ppw())]
    if "f" in rows:
        sections += [
            (f"fig3f: on-policy (V-trace) measured sweep, Catch and the learner on {where} — "
             "frame ledger", lines_3f(rows["f"])),
            ("fig3f: onpolicy_point model at paper scale (40 hw threads)", lines_3f_model())]
    return sections


def check_measured(rows):
    """Raise unless every measured row has frames, no inference error and
    finite seconds."""
    for r in rows:
        secs = [r.get(k) for k in ("learner_train_s", "learner_wait_s", "inference_compute_s")]
        frames = r["env_frames_per_s"] if "env_frames_per_s" in r else r["gen_frames_per_s"]
        if not frames > 0 or r.get("inference_error") \
                or not all(math.isfinite(x) for x in secs if x is not None):
            raise RuntimeError(f"a measured point failed: {r}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny measured windows (exercise the path)")
    ap.add_argument("--replicas", type=int, default=2,
                    help="widest point of the sharded-inference sweep (e)")
    ap.add_argument("--algo", choices=("r2d2", "vtrace"), default="r2d2",
                    help="r2d2: parts (a-e); vtrace: the on-policy sweep (f)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises where there is no card) or cpu")
    for flag in ("--telemetry", "--chaos", "--autoscale"):
        ap.add_argument(flag, action="store_true", help=f"not ported yet ({OPS_ITEM})")
    args = ap.parse_args(argv)
    for flag in ("telemetry", "chaos", "autoscale"):
        if getattr(args, flag):
            raise SystemExit(f"--{flag} needs the ops and survival planes, which are not "
                             f"ported yet ({OPS_ITEM})")
    dev = resolve(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    sec = 0.3 if args.smoke else 1.2
    if args.algo == "vtrace":
        rows = {"f": measured_vtrace_sweep(actor_counts=(1, 2) if args.smoke else (1, 2, 4),
                                           seconds=max(sec, 0.8), device=dev)}
    else:
        unroll = 8 if args.smoke else 16
        replica_counts = tuple(sorted({1, max(args.replicas, 1)}))
        rows = {
            "a": measured_sweep(actor_counts=(1, 2) if args.smoke else (1, 2, 4, 8),
                                seconds=sec),
            "c": measured_env_sweep(env_counts=(1, 4) if args.smoke else (1, 2, 4, 8),
                                    seconds=sec),
            "d": measured_backend_sweep(seconds=sec, unroll=unroll, device=dev),
            "t_dev": measure_t_dev(dev, lanes=(8, 4096) if args.smoke else T_DEV_LANES),
            "e": measured_replica_sweep(replica_counts=replica_counts, seconds=sec, device=dev),
            "shards": measured_engine_shard_sweep(shard_counts=replica_counts, seconds=sec,
                                                  unroll=unroll, device=dev)}
    for key, measured in rows.items():
        if key != "t_dev":
            check_measured(measured)
    print(f"# fig3 on {name}: ALESim and the random policy of (a) and (c) on the host; "
          f"Catch of (d)-(f) on {dev}")
    print("name,value,derived")
    for title, lines in report(rows, name, dev):
        print(f"# {title}")
        print("\n".join(lines))
    return rows


if __name__ == "__main__":
    main()
