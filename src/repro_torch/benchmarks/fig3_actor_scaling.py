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
  (g) TELEMETRY (``--telemetry``): a socket run (Catch on the hosts'
      CPUs, 2 actor hosts) under the full telemetry plane with the live
      ops plane bound (``ops_port=0``), scraped mid-run; then validates
      trace.json (a round trip stitched across processes), metrics.jsonl,
      the ledger against the registry, the measured CPU/GPU ratio and the
      Prometheus text, and gates the ops plane at < 3% frames/s.
  (h) CHAOS (``--chaos``): a V-trace socket run (the MLP learner on
      `device`, 2 hosts, 2 gateways, live checkpoints, supervision and
      reconnect armed) that has a host killed and a gateway connection
      severed by a scripted `ChaosMonkey`; recovery, /healthz and the
      exactly conserved ledger are checked, and the armed-but-idle fault
      plane is gated at < 3% frames/s.
  (i) AUTOSCALE (``--autoscale``): a deliberately actor-bound V-trace
      socket run (FlatSimEnv, one host to start) under
      `AutoscaleConfig`; it must grow until the bottleneck flips or the
      cap binds, log every applied resize at ``/autoscaler``, conserve the
      ledger, and the armed-but-idle controller is gated at < 3% frames/s.
  (g)-(i) write trace.json, metrics.jsonl, crashes/, BENCH_telemetry.json
  and BENCH_history.json under ``--out-dir`` (``build/bench_torch/``), and
  exit non-zero when any check fails.

Beside each measured row's frames/s it prints the learner's train and
wait seconds ("none" where the point runs no learner) and the inference
server's compute seconds (0 on the device backend, which has no server):
the learner, the server and the actor threads share one interpreter, so
frames/s alone measures that interpreter, not the CPU/GPU ratio.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig3_actor_scaling \\
        [--smoke] [--replicas N] [--algo r2d2|vtrace] [--device cuda|cpu]
        [--telemetry | --chaos | --autoscale] [--out-dir DIR]

Without ``--device cpu`` it runs on the card and raises where there is
none.
"""

import argparse
import functools
import json
import math
import os
import sys
import threading
import time
from collections import defaultdict

import numpy as np
import torch

from repro_torch.autoscale import AutoscaleConfig
from repro_torch.benchmarks.fig4_cpu_gpu_ratio import CPU_CATCH, ROOT, catch_policy
from repro_torch.benchmarks.timing import device_ms
from repro_torch.core.provisioning import fit_paper_actor_model
from repro_torch.core.system import SeedSystem
from repro_torch.device import resolve
from repro_torch.envs.alesim import ALESimEnv, FlatSimEnv
from repro_torch.envs.catch import CatchEnv
from repro_torch.fault import BackoffPolicy, ChaosEvent, ChaosMonkey
from repro_torch.hw import V100
from repro_torch.launch import rollout_backends, train_vtrace
from repro_torch.onpolicy import VTraceLearner, mlp_actor_critic
from repro_torch.optim import adamw
from repro_torch.telemetry import (Telemetry, append_bench_history, bench_commit,
                                   merge_bench_json, validate_prometheus)

# Fig 3f's point (benchmarks/fig3_actor_scaling.py:220-221)
VTRACE = dict(envs_per_actor=4, unroll=8, learner_batch=4, max_param_lag=50)
# the engine widths and unroll of the t_dev fit (chip_smoke.py phase 16)
T_DEV_LANES = (8, 64, 512, 4096)
T_DEV_UNROLL = 16
T_ENV_TRIALS = 5
# where parts (g)-(i) write their artifacts by default
DEFAULT_OUT_DIR = ROOT / "build" / "bench_torch"
# the overhead gates of parts (g)-(i): a frames/s share
OVERHEAD_GATE = 0.03


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


# -- parts (g)-(i): the ops and survival planes -------------------------------

def _telemetry_policy(obs, ids):
    # module-level, as the reference's (the policy itself stays on the
    # learner side; actor hosts never pickle it)
    return np.random.randint(0, CatchEnv.num_actions, size=(obs.shape[0],))


def _http_get(url, timeout=2.0):
    """GET returning (status, body-text); a 503 /healthz still has a JSON
    body worth reading, so HTTPError is a result, not an exception."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


class Checks:
    """The reference's check list: every failed check appends its message
    instead of raising, so one broken artifact still reports the state of
    all the others. `gate` marks the wall-clock overhead gates apart."""

    def __init__(self):
        self.failures, self.gate_failures = [], []

    def __call__(self, ok, what, gate=False):
        if not ok:
            self.failures.append(what)
            if gate:
                self.gate_failures.append(what)
        return ok


def _ops_overhead_gate(repeats=3, seconds=0.8):
    """The FULL ops plane (HTTP server + watchdog + auditor, nothing
    scraping) against the same in-process system under telemetry only:
    best-of-N frames/s of each, and the overhead share."""
    def best_fps(ops_port):
        best = 0.0
        for _ in range(repeats):
            tel = Telemetry(process_name="learner")
            system = SeedSystem(env_factory=CPU_CATCH, policy_step=_telemetry_policy,
                                num_actors=2, unroll=8, envs_per_actor=2, deadline_ms=2.0,
                                telemetry=tel, ops_port=ops_port)
            system.warmup()
            stats = system.run(seconds=seconds, with_learner=False)
            system.stop_ops()
            best = max(best, stats["env_frames_per_s"])
        return best

    base = best_fps(None)          # telemetry only: no ops/watchdog/auditor
    withops = best_fps(0)          # full ops plane enabled
    return base, withops, (1.0 - withops / base if base > 0 else 0.0)


def run_telemetry(smoke=True, out_dir=DEFAULT_OUT_DIR):
    """Part (g): the measured telemetry validation run (module docstring).
    Returns (payload, lines); ``payload["failures"]`` lists every failed
    check, ``payload["gate_failures"]`` those of the overhead gate."""
    out_dir = str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    sec = 0.3 if smoke else 1.2
    seconds = max(sec * 4, 1.2) if smoke else 4.0
    tel = Telemetry(process_name="learner", out_dir=out_dir)
    system = SeedSystem(env_factory=CPU_CATCH, policy_step=_telemetry_policy,
                        num_actors=2, unroll=8, envs_per_actor=2, deadline_ms=2.0,
                        transport="socket", num_actor_hosts=2, telemetry=tel, ops_port=0)
    ops_host, ops_port = system.ops_address
    ops_base = f"http://{ops_host}:{ops_port}"
    # scrape the live plane MID-run from a sidecar thread — the same shape
    # a Prometheus agent would use against a real deployment
    scrapes = {"metrics": [], "healthz": [], "errors": []}
    scr_stop = threading.Event()

    def _scrape_loop():
        while not scr_stop.wait(0.4):
            try:
                _, text = _http_get(ops_base + "/metrics")
                scrapes["metrics"].append(text)
                _, hz = _http_get(ops_base + "/healthz")
                scrapes["healthz"].append(json.loads(hz))
            except Exception as e:       # noqa: BLE001 — recorded, checked
                scrapes["errors"].append(str(e))

    scraper = threading.Thread(target=_scrape_loop, daemon=True)
    scraper.start()
    stats = system.run(seconds=seconds, with_learner=False)
    scr_stop.set()
    scraper.join(timeout=5.0)
    report = tel.bottleneck_report(stats)
    paths = tel.dump(out_dir)
    check = Checks()
    check(not stats["host_errors"], f"host errors: {stats['host_errors']}")
    check(stats["env_frames"] > 0, "no env frames in the measured window")

    # 1. trace.json parses and is Chrome-trace shaped
    events = []
    try:
        with open(paths["trace"]) as f:
            events = json.load(f).get("traceEvents", [])
        check(isinstance(events, list) and events, "trace.json has no traceEvents")
        check(all("ph" in e and "pid" in e for e in events), "trace event missing ph/pid")
    except (OSError, ValueError) as e:
        check(False, f"trace.json unreadable: {e}")

    # 2. >=1 round-trip stitched across >=2 processes by trace_seq
    by_seq = defaultdict(set)
    for e in events:
        if e.get("ph") == "X" and e.get("args", {}).get("trace_seq"):
            by_seq[e["args"]["trace_seq"]].add(e["pid"])
    stitched = sum(1 for pids in by_seq.values() if len(pids) >= 2)
    check(stitched >= 1,
          f"no round-trip stitched across 2+ processes ({len(by_seq)} seqs seen)")

    # 3. metrics.jsonl non-empty, with percentiles for batch wait + RTT
    lines = []
    try:
        with open(paths["metrics"]) as f:
            lines = [json.loads(ln) for ln in f if ln.strip()]
        check(bool(lines), "metrics.jsonl is empty")
    except (OSError, ValueError) as e:
        check(False, f"metrics.jsonl unreadable: {e}")
    wait_h = tel.merged_histogram("inference/batch_wait_s")
    rtt_h = tel.merged_histogram("wire/rtt_s")
    check(bool(wait_h and wait_h.get("p50") is not None and wait_h.get("p99") is not None),
          "no p50/p99 for inference/batch_wait_s")
    check(bool(rtt_h and rtt_h.get("p50") is not None and rtt_h.get("p99") is not None),
          "no p50/p99 for wire/rtt_s")

    # 4. frame ledger vs telemetry counters: the registry's lane counter
    # IS the source of stats["inference_lanes"] (exact), and actor frames
    # can trail served lanes only by the in-flight round-trips at stop
    lanes = tel._counter_total("/requests")
    check(int(lanes) == int(stats["inference_lanes"]),
          f"registry lanes {lanes} != stats {stats['inference_lanes']}")
    in_flight = 2 * 2  # num_actors * envs_per_actor
    check(0 <= lanes - stats["env_frames"] <= in_flight,
          f"ledger drift: {lanes} lanes served vs {stats['env_frames']} frames stepped")

    # 5. measured CPU/GPU ratio is finite and the window classified
    check(np.isfinite(report.cpu_gpu_ratio), "cpu_gpu_ratio not finite")
    check(report.bottleneck.endswith("-bound") or report.bottleneck == "idle",
          f"unclassified window: {report.bottleneck!r}")

    # 6. live ops plane: mid-run scrapes happened and the LAST /metrics
    # (plus a final post-run one) passes the Prometheus validator
    check(bool(scrapes["metrics"]),
          f"no mid-run /metrics scrape landed (errors: {scrapes['errors']})")
    check(bool(scrapes["healthz"]), "no mid-run /healthz scrape landed")
    promlint = []
    for text in scrapes["metrics"][-1:]:
        promlint.extend(validate_prometheus(text))
    _, final_text = _http_get(ops_base + "/metrics", timeout=5.0)
    promlint.extend(validate_prometheus(final_text))
    for v in promlint:
        check(False, f"prometheus exposition: {v}")
    verdicts = sorted({h.get("verdict", "?") for h in scrapes["healthz"]})
    check(all(v in ("healthy", "degraded", "stalled") for v in verdicts),
          f"unparseable /healthz verdicts: {verdicts}")
    system.stop_ops()

    # 7. ops plane overhead vs telemetry-only (in-proc, best-of-N)
    fps_base, fps_ops, ops_overhead = _ops_overhead_gate(seconds=max(sec * 2, 0.6))
    check(ops_overhead < OVERHEAD_GATE,
          f"ops plane costs {ops_overhead:.1%} frames/s ({fps_ops:.0f} vs {fps_base:.0f}) "
          f"— gate is 3%", gate=True)

    payload = {
        "seconds": seconds, "env_frames": stats["env_frames"],
        "env_frames_per_s": stats["env_frames_per_s"], "stitched_roundtrips": stitched,
        "trace_events": len(events), "metrics_lines": len(lines),
        "batch_wait_p50_s": wait_h.get("p50") if wait_h else None,
        "batch_wait_p99_s": wait_h.get("p99") if wait_h else None,
        "wire_rtt_p50_s": rtt_h.get("p50") if rtt_h else None,
        "wire_rtt_p99_s": rtt_h.get("p99") if rtt_h else None,
        "bottleneck": report.as_dict(), "ops_scrapes": len(scrapes["metrics"]),
        "ops_healthz_verdicts": verdicts, "ops_metrics_lines": len(final_text.splitlines()),
        "fps_telemetry_only": fps_base, "fps_with_ops": fps_ops,
        "ops_overhead_frac": ops_overhead, "failures": check.failures,
    }
    merge_bench_json(os.path.join(out_dir, "BENCH_telemetry.json"), "fig3_telemetry", payload)
    append_bench_history(
        os.path.join(out_dir, "BENCH_history.json"), "fig3_telemetry",
        {"commit": bench_commit(), "ts": time.time(),
         "frames_per_s": stats["env_frames_per_s"], "smoke": bool(smoke)})
    payload["gate_failures"] = check.gate_failures
    out = ["# fig3g: telemetry validation (socket transport, 2 hosts)",
           f"fig3g_frames_per_s,{stats['env_frames_per_s']:.1f},frames={stats['env_frames']}",
           f"fig3g_stitched_roundtrips,{stitched},of {len(by_seq)} seqs",
           f"fig3g_trace_events,{len(events)},{paths['trace']}",
           f"fig3g_metrics_lines,{len(lines)},{paths['metrics']}"]
    if rtt_h:
        out.append(f"fig3g_wire_rtt_p50_us,{rtt_h['p50'] * 1e6:.0f},"
                   f"p99_us={rtt_h['p99'] * 1e6:.0f}")
    if wait_h:
        out.append(f"fig3g_batch_wait_p50_us,{wait_h['p50'] * 1e6:.0f},"
                   f"p99_us={wait_h['p99'] * 1e6:.0f}")
    out += [f"fig3g_cpu_gpu_ratio,{report.cpu_gpu_ratio:.2f},{report.bottleneck}",
            f"fig3g_ops_scrapes,{len(scrapes['metrics'])},"
            f"mid-run /metrics+/healthz verdicts={'/'.join(verdicts)}",
            f"fig3g_ops_overhead_pct,{100.0 * ops_overhead:.2f},"
            f"with_ops={fps_ops:.0f} telemetry_only={fps_base:.0f} gate=3%"]
    out += [f"# {line}" for line in str(report).splitlines()]
    return payload, out + _verdict_lines("fig3g", check, "all telemetry checks passed")


def _verdict_lines(prefix, check, ok_text):
    if check.failures:
        return [f"{prefix}_FAIL,1,{f_}" for f_ in check.failures]
    return [f"{prefix}_ok,1,{ok_text}"]


def _fault_overhead_gate(repeats=3, seconds=0.8):
    """The survival plane must be free when nothing dies: a socket run
    with supervision + reconnect ARMED (but no chaos) against the same
    run without them, best-of-N frames/s each."""
    def best_fps(fault):
        kw = dict(supervise_hosts=True, wire_reconnect=BackoffPolicy()) if fault else {}
        best = 0.0
        for _ in range(repeats):
            system = SeedSystem(env_factory=CPU_CATCH, policy_step=_telemetry_policy,
                                num_actors=2, unroll=8, envs_per_actor=2, deadline_ms=2.0,
                                transport="socket", num_actor_hosts=1, **kw)
            stats = system.run(seconds=seconds, with_learner=False)
            best = max(best, stats["env_frames_per_s"])
        return best

    base = best_fps(False)       # the historical fail-fast wire
    withf = best_fps(True)       # supervision + reconnect armed, idle
    return base, withf, (1.0 - withf / base if base > 0 else 0.0)


def _vtrace_learner(obs_dim, num_actions, device, lanes, batch_size):
    """The MLP V-trace learner on `device` from seed 0, its sampling policy
    warmed at each batch of `lanes`, and its train step at `batch_size`."""
    init_fn, apply_fn = mlp_actor_critic(obs_dim, num_actions)
    vl = VTraceLearner(apply_fn, adamw(1e-3))
    params = init_fn(torch.Generator().manual_seed(0), device)
    state = vl.init_state(params)
    policy = vl.sampling_policy(params)
    for n in lanes:
        policy(np.zeros((n, obs_dim), np.float32), None)
    vl.warmup(state, batch_size=batch_size, unroll=8, obs_shape=(obs_dim,))
    return vl, state, policy


def run_chaos(smoke=True, out_dir=DEFAULT_OUT_DIR, device="cuda"):
    """Part (h): the survivable serving plane under injected faults
    (module docstring). Returns (payload, lines) as `run_telemetry`."""
    out_dir = str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    sec = 0.3 if smoke else 1.2
    check = Checks()
    dev = resolve(device)
    obs_dim = int(np.prod(CPU_CATCH().obs_shape))
    vl, state, policy = _vtrace_learner(obs_dim, CatchEnv.num_actions, dev, (4, 8), 4)
    tel = Telemetry(process_name="learner", out_dir=out_dir)
    tel.health.event_window_s = 3.0   # fault events age out before the
    #                                   final "healed" check below
    system = SeedSystem(env_factory=CPU_CATCH, policy_step=policy,
                        num_actors=2, unroll=8, envs_per_actor=4,
                        deadline_ms=1.0, algo="vtrace", max_param_lag=100,
                        train_step=vl.train_step, state=state,
                        learner_batch=4, policy_publish=policy.publish,
                        transport="socket", num_actor_hosts=2,
                        num_gateways=2, telemetry=tel, ops_port=0,
                        checkpoint_dir=os.path.join(out_dir, "chaos_ckpt"),
                        checkpoint_every_s=1.0,
                        supervise_hosts=True, host_stall_s=4.0,
                        wire_reconnect=BackoffPolicy(base_s=0.05, cap_s=0.5,
                                                     max_retries=8, seed=0))
    ops_host, ops_port = system.ops_address
    base_url = f"http://{ops_host}:{ops_port}"
    seconds = 8.0 if smoke else 12.0
    # the schedule is fixed data; its anchor is adaptive (children pay the
    # torch import and env warm-up before serving, so wall-clock offsets
    # from run() start would race the spawn). Host 1 hashes to gateway 1,
    # so the sever hits the SURVIVING host's wire — the one that must
    # reconnect and live to report it.
    monkey = ChaosMonkey.scripted(
        ChaosEvent(0.5, "kill_actor_host", target=0),
        ChaosEvent(2.5, "sever_gateway_conn", target=1))
    verdicts = set()
    done = threading.Event()

    def _poll():
        while not done.wait(0.25):
            try:
                _, hz = _http_get(base_url + "/healthz")
                verdicts.add(json.loads(hz)["verdict"])
            except Exception:
                pass

    def _arm_when_hosts_up():
        deadline = time.perf_counter() + 60.0
        while time.perf_counter() < deadline and not done.is_set():
            try:
                _, hz = _http_get(base_url + "/healthz")
                comps = json.loads(hz)["components"]
                if "actor-host-0" in comps and "actor-host-1" in comps:
                    monkey.start(system)
                    return
            except Exception:
                pass
            time.sleep(0.2)

    threading.Thread(target=_poll, daemon=True).start()
    threading.Thread(target=_arm_when_hosts_up, daemon=True).start()
    try:
        stats = system.run(seconds=seconds)
    finally:
        done.set()
        monkey.stop()
    check(len(monkey.injected) == 2 and all(i[2] for i in monkey.injected),
          f"chaos injection incomplete: {monkey.injected}")
    check(stats["host_errors"] == [], f"host errors: {stats['host_errors']}")
    check(stats["learner_steps"] > 0, "learner never stepped")
    onp = stats["onpolicy"]
    check(onp["frames_generated"] == (onp["frames_trained"] + onp["frames_dropped"]
                                      + onp["frames_pending"]),
          f"frame ledger NOT conserved: {onp}")
    check(onp["frames_pending"] == 0, f"frames still pending at rest: {onp['frames_pending']}")
    rec = stats["recovery"]
    check(rec["host_restarts"] >= 1, f"no host respawn: {rec}")
    check(rec["reconnects"] >= 1, f"no client reconnect: {rec}")
    check(rec["checkpoint_saves"] >= 1, f"no live-loop checkpoint: {rec}")
    check(system.server.num_slots <= system.num_actors * system.envs_per_actor,
          f"slot table grew past the lane budget: {system.server.num_slots}")
    check("degraded" in verdicts, f"faults were never observable on /healthz: {verdicts}")
    check(any("host_death" in b for b in tel.flightrec.bundles),
          f"no host_death postmortem: {tel.flightrec.bundles}")
    healed, hz = False, ""
    deadline = time.perf_counter() + 6.0
    while time.perf_counter() < deadline:
        status, hz = _http_get(base_url + "/healthz")
        if status == 200 and json.loads(hz)["verdict"] == "healthy":
            healed = True
            break
        time.sleep(0.25)
    check(healed, f"/healthz never healed after the faults: {hz}")
    system.stop_ops()

    fps_base, fps_fault, frac = _fault_overhead_gate(seconds=max(sec * 2, 0.6))
    check(frac < OVERHEAD_GATE,
          f"armed fault plane costs {frac:.1%} frames/s ({fps_fault:.0f} vs {fps_base:.0f}) "
          f"— gate is 3%", gate=True)
    payload = {
        "seconds": seconds, "env_frames": stats["env_frames"],
        "env_frames_per_s": stats["env_frames_per_s"],
        "learner_steps": stats["learner_steps"],
        "ledger": {k: onp[k] for k in ("frames_generated", "frames_trained", "frames_dropped",
                                       "frames_dropped_fault", "frames_pending")},
        "recovery": rec, "healthz_verdicts": sorted(verdicts),
        "fps_fail_fast": fps_base, "fps_fault_armed": fps_fault,
        "fault_overhead_frac": frac, "failures": check.failures,
    }
    merge_bench_json(os.path.join(out_dir, "BENCH_telemetry.json"), "fig3_chaos", payload)
    payload["gate_failures"] = check.gate_failures
    out = ["# fig3h: chaos-injected survival run (vtrace, socket, 2 hosts)",
           f"fig3h_frames_per_s,{stats['env_frames_per_s']:.1f},"
           f"frames={stats['env_frames']} learner_steps={stats['learner_steps']}",
           f"fig3h_host_restarts,{rec['host_restarts']},host_faults={rec['host_faults']} "
           f"reconnects={rec['reconnects']} gateway_failovers={rec['gateway_failovers']}",
           f"fig3h_frames_dropped_fault,{onp['frames_dropped_fault']},"
           f"generated={onp['frames_generated']} trained={onp['frames_trained']} "
           f"pending={onp['frames_pending']}",
           f"fig3h_checkpoint_saves,{rec['checkpoint_saves']},live-loop cadence 1.0s",
           f"fig3h_healthz,{'/'.join(sorted(verdicts))},healed={healed}",
           f"fig3h_fault_overhead_pct,{100.0 * frac:.2f},"
           f"armed={fps_fault:.0f} fail_fast={fps_base:.0f} gate=3%"]
    return payload, out + _verdict_lines("fig3h", check, "all chaos checks passed")


def _autoscale_overhead_gate(repeats=3, seconds=0.8):
    """The closed loop while it merely watches: an in-process run with the
    controller ARMED (sensing, deciding, logging every tick, no pool to
    resize) against the same telemetry-only run, best-of-N frames/s."""
    def best_fps(armed):
        best = 0.0
        for _ in range(repeats):
            kw = {"autoscale": AutoscaleConfig(interval_s=0.25)} if armed else {}
            tel = Telemetry(process_name="learner")
            system = SeedSystem(env_factory=CPU_CATCH, policy_step=_telemetry_policy,
                                num_actors=2, unroll=8, envs_per_actor=2, deadline_ms=2.0,
                                telemetry=tel, **kw)
            system.warmup()
            stats = system.run(seconds=seconds, with_learner=False)
            best = max(best, stats["env_frames_per_s"])
        return best

    base = best_fps(False)       # telemetry only, controller absent
    armed = best_fps(True)       # controller sensing/deciding every tick
    return base, armed, (1.0 - armed / base if base > 0 else 0.0)


def run_autoscale(smoke=True, out_dir=DEFAULT_OUT_DIR, device="cuda"):
    """Part (i): the closed-loop elastic autoscaler, end to end (module
    docstring). Returns (payload, lines) as `run_telemetry`."""
    out_dir = str(out_dir)
    sec = 0.3 if smoke else 1.2
    check = Checks()
    os.makedirs(out_dir, exist_ok=True)
    dev = resolve(device)
    env_factory = functools.partial(FlatSimEnv, step_cost=20000)
    vl, state, policy = _vtrace_learner(FlatSimEnv().obs_dim, FlatSimEnv.num_actions, dev,
                                        (4, 8, 16), 2)
    tel = Telemetry(process_name="learner", out_dir=out_dir)
    # generous staleness bound + small learner batch: the learner must
    # keep up, so the window stays ACTOR-bound (the premise under test)
    system = SeedSystem(env_factory=env_factory, policy_step=policy,
                        num_actors=4, unroll=8, envs_per_actor=2,
                        deadline_ms=2.0, algo="vtrace",
                        train_step=vl.train_step, state=state,
                        learner_batch=2, max_param_lag=10 ** 6,
                        policy_publish=policy.publish,
                        transport="socket", num_actor_hosts=1,
                        telemetry=tel, ops_port=0,
                        autoscale=AutoscaleConfig(
                            interval_s=0.25, max_hosts=3,
                            grow_after_ticks=2, cooldown_s=1.5,
                            churn_window_s=2.0))
    ops_host, ops_port = system.ops_address
    base_url = f"http://{ops_host}:{ops_port}"
    seconds = 8.0 if smoke else 12.0
    scrapes = {"autoscaler": [], "timeseries": [], "errors": []}
    done = threading.Event()

    def _scrape_loop():
        while not done.wait(0.4):
            try:
                _, body = _http_get(base_url + "/autoscaler")
                scrapes["autoscaler"].append(json.loads(body))
                _, ts = _http_get(base_url + "/timeseries?window=30")
                scrapes["timeseries"].append(json.loads(ts))
            except Exception as e:       # noqa: BLE001 — recorded, checked
                scrapes["errors"].append(str(e))

    threading.Thread(target=_scrape_loop, daemon=True).start()
    try:
        stats = system.run(seconds=seconds)
    finally:
        done.set()
    # final scrape AFTER the window: the complete decision log, over HTTP
    status, body = _http_get(base_url + "/autoscaler", timeout=5.0)
    final = json.loads(body) if status == 200 else {}
    system.stop_ops()

    check(status == 200, f"/autoscaler returned {status}")
    check(stats["host_errors"] == [], f"host errors: {stats['host_errors']}")
    check(stats["learner_steps"] > 0, "learner never stepped")
    # conserved ledger across grow (and any drain)
    onp = stats["onpolicy"]
    check(onp["frames_generated"] == (onp["frames_trained"] + onp["frames_dropped"]
                                      + onp["frames_pending"]),
          f"frame ledger NOT conserved across resizes: {onp}")
    check(onp["frames_pending"] == 0, f"frames still pending at rest: {onp['frames_pending']}")
    # convergence: grew, then flipped away from actor-bound or hit the cap
    entries = final.get("decisions", {}).get("entries", [])
    grown = stats.get("hosts_grown", 0)
    applied_total = sum(final.get("actions_applied", {}).values())
    check(grown >= 1, f"actor-bound run never grew a host (hosts_grown={grown})")
    saturated = any(e["action"]["saturated"] and e["action"]["candidate"] == "grow_hosts"
                    for e in entries)
    tail = [e["bottleneck"].get("bottleneck") for e in entries[-8:]]
    flipped = bool(tail) and tail[-1] != "actor-bound"
    check(saturated or flipped,
          f"no convergence: never saturated grow_hosts nor flipped away from actor-bound "
          f"(tail classes: {tail})")
    # every applied resize is scrapeable evidence at /autoscaler
    applied_entries = [e for e in entries if e.get("applied")]
    check(len(applied_entries) == applied_total,
          f"{applied_total} applied actions but {len(applied_entries)} applied "
          f"decision-log entries scraped")
    for e in applied_entries:
        ok = (e.get("trigger") and "bottleneck" in e and "slo" in e
              and "topology_before" in e and "topology_after" in e)
        check(ok, f"applied decision entry missing evidence: {sorted(e.keys())}")
    check(bool(scrapes["autoscaler"]),
          f"no mid-run /autoscaler scrape landed (errors: {scrapes['errors'][:3]})")
    series_seen = set()
    for ts_doc in scrapes["timeseries"][-1:]:
        series_seen = set(ts_doc.get("series", {}))
    check("frames_generated" in series_seen,
          f"/timeseries missing frames_generated (saw {sorted(series_seen)[:8]})")

    fps_off, fps_armed, frac = _autoscale_overhead_gate(seconds=max(sec * 2, 0.6))
    check(frac < OVERHEAD_GATE,
          f"armed-but-idle autoscaler costs {frac:.1%} frames/s ({fps_armed:.0f} vs "
          f"{fps_off:.0f}) — gate is 3%", gate=True)
    payload = {
        "seconds": seconds, "env_frames": stats["env_frames"],
        "env_frames_per_s": stats["env_frames_per_s"],
        "learner_steps": stats["learner_steps"], "hosts_grown": grown,
        "hosts_drained": stats.get("hosts_drained", 0),
        "actor_hosts_live": stats.get("actor_hosts_live"),
        "actions_applied": final.get("actions_applied", {}),
        "decision_entries": len(entries),
        "converged_by": ("saturated" if saturated else "flipped" if flipped else "none"),
        "ledger": {k: onp[k] for k in ("frames_generated", "frames_trained", "frames_dropped",
                                       "frames_pending")},
        "fps_autoscale_off": fps_off, "fps_autoscale_armed": fps_armed,
        "autoscale_overhead_frac": frac, "failures": check.failures,
    }
    merge_bench_json(os.path.join(out_dir, "BENCH_telemetry.json"), "fig3_autoscale", payload)
    append_bench_history(
        os.path.join(out_dir, "BENCH_history.json"), "fig3_autoscale",
        {"commit": bench_commit(), "ts": time.time(),
         "frames_per_s": stats["env_frames_per_s"], "smoke": bool(smoke)})
    payload["gate_failures"] = check.gate_failures
    out = ["# fig3i: closed-loop autoscaler (vtrace, socket, actor-bound)",
           f"fig3i_frames_per_s,{stats['env_frames_per_s']:.1f},"
           f"frames={stats['env_frames']} learner_steps={stats['learner_steps']}",
           f"fig3i_hosts_grown,{grown},live={stats.get('actor_hosts_live')} "
           f"drained={stats.get('hosts_drained', 0)} cap=3",
           f"fig3i_decisions,{len(entries)},applied={applied_total} "
           f"converged_by={payload['converged_by']}",
           f"fig3i_ledger,{onp['frames_generated']},trained={onp['frames_trained']} "
           f"dropped={onp['frames_dropped']} pending={onp['frames_pending']}",
           f"fig3i_scrapes,{len(scrapes['autoscaler'])},mid-run /autoscaler + /timeseries",
           f"fig3i_overhead_pct,{100.0 * frac:.2f},armed={fps_armed:.0f} off={fps_off:.0f} "
           f"gate=3%"]
    return payload, out + _verdict_lines("fig3i", check, "all autoscale checks passed")


OPS_MODES = {"telemetry": run_telemetry, "chaos": run_chaos, "autoscale": run_autoscale}


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
    ap.add_argument("--telemetry", action="store_true",
                    help="part (g): socket run under the telemetry plane, validating "
                         "trace/metrics/ratio artifacts")
    ap.add_argument("--chaos", action="store_true",
                    help="part (h): chaos-injected vtrace socket run (host killed + gateway "
                         "conn severed) gating the conserved ledger and fault-path overhead")
    ap.add_argument("--autoscale", action="store_true",
                    help="part (i): deliberately actor-bound vtrace socket run under the "
                         "closed-loop autoscaler, gating convergence, /autoscaler decision "
                         "evidence, the conserved ledger and armed-idle overhead")
    ap.add_argument("--out-dir", default=str(DEFAULT_OUT_DIR),
                    help="where --telemetry/--chaos/--autoscale write trace.json, "
                         "metrics.jsonl, crashes/, BENCH_telemetry.json and "
                         "BENCH_history.json")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    for mode, fn in OPS_MODES.items():
        if getattr(args, mode):
            kw = {} if mode == "telemetry" else {"device": dev}
            payload, lines = fn(args.smoke, args.out_dir, **kw)
            print("name,value,derived")
            print("\n".join(lines))
            if payload["failures"]:
                sys.exit(1)
            return payload
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
