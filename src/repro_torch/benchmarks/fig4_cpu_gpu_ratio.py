"""Fig 4 on the card's machine: accelerator derating, the CPU/GPU-ratio
metric across real systems and the provisioning rule, and the measured
cost of turning the ratio knob: the same SEED system in process, over a
loopback-TCP gateway and over the shared-memory rings, each wire's probed
round trip threaded back through `SystemModel.with_network(..., wire=...)`.

The port's counterpart of ``benchmarks/fig4_cpu_gpu_ratio.py``, printing
its rows under the same names; where the reference prints and provisions
a TPU v5e host, this prints this machine with one H100 (`h100_host`,
`H100_SXM`). The measured sweep runs Catch on the host's CPU at every
point (in process and in each spawned actor host, which must not open a
CUDA context) and a deterministic numpy policy on the host, as the
reference's numpy policy of numpy observations: this part measures the
host and the wire, not the card. The wire numbers are written to
``--out`` (``build/bench_torch/BENCH_torch_wire.json`` by default).

    PYTHONPATH=src python -m repro_torch.benchmarks.fig4_cpu_gpu_ratio \\
        [--smoke] [--gateways G] [--transport socket|shm|all] [--device cuda|cpu]

Whenever the shm plane is swept (``--transport shm`` or ``all``), the
best-of-N "shm beats loopback TCP" probe is a hard gate (non-zero exit),
as the reference's code has it. Without ``--device cpu`` it raises where there
is no card. ``--telemetry`` runs each transport point under its own
`repro_torch.telemetry.Telemetry`, prints the measured bottleneck and
CPU/GPU ratio of each, and merges them into ``BENCH_telemetry.json`` beside
``--out``; every run appends its wire points' frames/s to
``BENCH_history.json`` there.
"""

import argparse
import functools
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.provisioning import (SystemModel, cpu_gpu_ratio,
                                           cpu_gpu_ratio_breakdown,
                                           fit_paper_actor_model,
                                           fit_paper_derating, provision)
from repro_torch.core.system import SeedSystem
from repro_torch.device import resolve
from repro_torch.envs.catch import CatchEnv
from repro_torch.hw import DGX1_HOST, H100_SXM, V100, h100_host
from repro_torch.telemetry import (Telemetry, append_bench_history, bench_commit,
                                   merge_bench_json)

ROOT = Path(__file__).resolve().parents[3]
DEFAULT_OUT = ROOT / "build" / "bench_torch" / "BENCH_torch_wire.json"
# Catch on the host's CPU wherever it runs; a partial pickles for the children
CPU_CATCH = functools.partial(CatchEnv, device="cpu")


def catch_policy(obs, ids):
    """A deterministic action from each lane's obs, independent of slot
    order, so that measured runs stay comparable."""
    flat = np.abs(obs.reshape(obs.shape[0], -1))
    return (flat.sum(axis=1) * 997.0).astype(np.int64) % CatchEnv.num_actions


def derating_rows():
    """(SMs of 80, slowdown) at the paper's calibration."""
    m = fit_paper_derating()
    return [(sms, float(m.slowdown(sms / 80.0))) for sms in (80, 64, 40, 20, 8, 2)]


def ratio_rows(host=None):
    """The CPU/GPU ratio of the DGX-1, the DGX A100 and this machine with
    one H100 (`host` defaults to `h100_host()`)."""
    host = host or h100_host()
    return [
        ("dgx1", cpu_gpu_ratio(DGX1_HOST, V100, 8)),          # paper: 1/16
        ("dgx_a100", 256 / (8 * 108 * (312e12 / 108) / (125e12 / 80))),
        ("h100_host_1chip", cpu_gpu_ratio(host, H100_SXM, 1)),
    ]


def disaggregated_rows():
    return [(k, cpu_gpu_ratio_breakdown([DGX1_HOST] * k, V100, 8).total)
            for k in (1, 2, 4, 8, 16)]


def sharded_rows():
    """with_sharded at paper scale: throughput over one replica at 4 hosts
    and 160 actors."""
    model, _ = fit_paper_actor_model()
    m_net = model.with_network(0.2, n_hosts=4)
    base = float(m_net.throughput(160))
    return [(R, float(m_net.with_sharded(R).throughput(160)) / base) for R in (1, 2, 4, 8)]


def replica_ratio_rows():
    return cpu_gpu_ratio_breakdown([DGX1_HOST] * 3, V100, 8, n_replicas=2).per_replica


PROVISION_WORKLOADS = (("r2d2_atari_2M", 2e6), ("lm_policy_1B", 2e9),
                       ("lm_policy_32B_active", 6.4e10))


def provision_rows(host=None):
    """Host threads each workload needs on this machine with one H100."""
    host = host or h100_host()
    return [(name, provision(H100_SXM, host, 1, train_flops_per_frame=6 * flops_frame,
                             infer_flops_per_frame=2 * flops_frame, mfu=0.4))
            for name, flops_frame in PROVISION_WORKLOADS]


def measured_transport_sweep(num_actors=2, envs_per_actor=4, seconds=1.0, unroll=8,
                             num_actor_hosts=2, num_gateways=1,
                             transports=("inproc", "socket", "shm"), telemetry=False):
    """The same (num_actors, E) SEED system on Catch (on the host's CPU at
    every point), in process vs loopback TCP vs shared-memory rings. With
    `num_gateways > 1` the wire runs shard the accept loop: G gateways (+ G
    inference replicas) with the actor hosts hashed across them.
    ``telemetry=True`` runs each point under its own `Telemetry`, so every
    stats dict carries a measured ``bottleneck`` attribution. Returns
    (transport, stats) rows."""
    rows = []
    for transport in transports:
        tel = Telemetry(process_name="learner") if telemetry else None
        kwargs = dict(env_factory=CPU_CATCH, policy_step=catch_policy,
                      num_actors=num_actors, unroll=unroll,
                      envs_per_actor=envs_per_actor, deadline_ms=1.0,
                      transport=transport, telemetry=tel)
        if transport in ("socket", "shm"):
            kwargs.update(num_actor_hosts=num_actor_hosts, num_gateways=num_gateways,
                          num_replicas=num_gateways)
        system = SeedSystem(**kwargs)
        system.warmup()
        stats = system.run(seconds=seconds, with_learner=False)
        rows.append((transport, stats))
    return rows


def measure_wire_ping(envs_per_actor=4, pings=200, trials=3):
    """Best-of-N probe of both wire planes: the same lane-batched request
    round-tripped through a loopback-TCP gateway connection, through a
    CODEC_SHM ring pair on a second connection to the SAME gateway, and
    through the in-process queue. Best-of-N (min over trials) because the
    quantity of interest is the transport floor, not scheduler noise.

    Returns ``(best, shm_active)`` — best maps {"tcp","shm","inproc"} to
    per-round-trip seconds; shm_active says whether the ring pair was
    actually granted + attached (False means the "shm" column measured the
    TCP spill path and must not gate anything).
    """
    from repro_torch.core.inference import InferenceServer
    from repro_torch.transport.socket import (InferenceGateway, ShmTransport,
                                              SyncSocketTransport)

    srv = InferenceServer(catch_policy, max_batch=envs_per_actor, deadline_ms=0.5)
    srv.start()
    gw = InferenceGateway(srv)
    addr = gw.start()
    tcp = SyncSocketTransport.connect(addr)
    shm = ShmTransport.connect(addr)
    shm.wait_hello(5.0)
    obs = np.zeros((envs_per_actor,) + CPU_CATCH().obs_shape, np.float32)
    best = {}
    try:
        def ping(submit):
            for _ in range(20):                      # warm
                submit(obs).get(timeout=5.0)
            t0 = time.perf_counter()
            for _ in range(pings):
                submit(obs).get(timeout=5.0)
            return (time.perf_counter() - t0) / pings

        for _ in range(max(int(trials), 1)):
            for name, submit in (
                    ("tcp", lambda o: tcp.submit_batch(0, o)),
                    ("shm", lambda o: shm.submit_batch(1, o)),
                    ("inproc", lambda o: srv.submit_batch(2, o))):
                t = ping(submit)
                best[name] = min(best.get(name, t), t)
        shm_active = shm.shm_active and shm.shm_frames > 0
    finally:
        tcp.close()
        shm.close()
        gw.stop()
        srv.stop()
    return best, shm_active


def wire_bytes_table(envs_per_actor=4):
    """Bytes/frame ledger for representative payloads under each framing.

    Catch observations are (50,) float32 boards that are mostly zeros with
    a couple of ones — exactly the shape where RLE (on the uint8 view),
    F16 (2x), and Q8 (4x + 8-byte scale/offset prologue) earn their HELLO
    bits. TRAJ_BATCH amortizes the 24-byte frame header + per-record keys
    across a whole unroll flush.
    """
    from repro_torch.transport import codec as C

    f32 = np.zeros((envs_per_actor,) + CPU_CATCH().obs_shape, np.float32)
    f32[:, 0] = 1.0
    f32[:, 7] = 1.0
    u8 = f32.astype(np.uint8)

    def req(obs, **kw):
        return len(C.encode_request(7, 1, obs, **kw))

    traj = {"obs": f32, "action": np.zeros(envs_per_actor, np.int64),
            "reward": np.zeros(envs_per_actor, np.float32)}
    return {
        "request_obs_f32_raw": req(f32),
        "request_obs_f32_f16": req(f32, quant="f16"),
        "request_obs_f32_q8": req(f32, quant="q8"),
        "request_obs_u8_raw": req(u8),
        "request_obs_u8_rle": req(u8, compress=True),
        "traj_record_solo": len(C.encode_trajectory(3, traj)),
        "traj_record_in_batch8":
            len(C.encode_traj_batch(3, [traj] * 8)) / 8.0,
    }


def transport_model_check(rows, num_actors, envs_per_actor, t_rtt,
                          wire="tcp", measured_key="socket"):
    """Calibrate t_env from the in-proc run only, add the independently
    probed wire RTT via `with_network(..., wire=...)`, and predict the
    wire run — checking the model reproduces the measured throughput
    ordering. Called once per wire plane: the tcp and shm operating
    points are the SAME model at different probed t_rtt."""
    fps = {t: s["env_frames_per_s"] for t, s in rows}
    # per-actor cycle time: one cycle supplies E frames from each of n actors
    cycle_in = num_actors * envs_per_actor / fps["inproc"]
    base = SystemModel(t_env=cycle_in / envs_per_actor,
                       t_inf0=0.0, t_inf1=0.0,
                       hw_threads=os.cpu_count() or 1,
                       envs_per_actor=envs_per_actor)
    model_in = float(base.throughput(num_actors))
    model_net = float(base.with_network(t_rtt, wire=wire)
                      .throughput(num_actors))
    ordered = (model_net <= model_in) == \
        (fps[measured_key] <= fps["inproc"])
    return model_in, model_net, ordered


def model_lines(host=None):
    """Every model row: derating, the ratios, disaggregation."""
    host = host or h100_host()
    out = ["# fig4: slowdown vs compute fraction (40 CPU threads fixed)"]
    out += [f"fig4_slowdown_{sms}sm,{s:.3f},paper_at_40sm=1.06" for sms, s in derating_rows()]
    out.append("# cpu/gpu ratio of real systems (paper Conclusion 3: want >= 1); "
               f"h100_host: {host.hw_threads} host threads, one H100")
    out += [f"ratio_{name},{r:.4f},threads_per_v100_sm_equivalent"
            for name, r in ratio_rows(host)]
    out.append("# ratio, disaggregated: K actor hosts behind repro_torch.transport")
    for k, total in disaggregated_rows():
        verdict = "balanced" if total >= 1.0 else "starved"
        out.append(f"ratio_dgx1_{k}hosts,{total:.4f},"
                   f"{k}x{DGX1_HOST.hw_threads}threads {verdict}")
    return out


def sharded_lines():
    out = ["# sharded inference plane: with_sharded at paper scale, and the",
           "# per-replica ratio decomposition (hosts hash to replicas)"]
    out += [f"fig4_model_sharded_{R},{s:.3f},throughput_vs_1_replica_at_4hosts_160actors"
            for R, s in sharded_rows()]
    out += [f"fig4_ratio_replica_{r},{ratio:.4f},threads={threads:.0f} over_sm_slice "
            f"(3 hosts hashed across 2 replicas -> imbalance visible)"
            for r, threads, ratio in replica_ratio_rows()]
    return out


def provision_lines(host=None):
    host = host or h100_host()
    out = [f"# provisioning: host threads needed per workload (this machine, "
           f"{host.hw_threads} threads, one H100)"]
    out += [f"provision_{name},{p.threads_required:.1f},threads_needed "
            f"demand={p.frames_demand_per_s:.0f}fps balanced={p.balanced}"
            for name, p in provision_rows(host)]
    return out


def report(wire_lines) -> list:
    """The report's sections, [(title, lines)], around `wire_sweep`'s
    lines: the model rows, the sweep, then the sharded and provisioning
    rows."""
    return [("fig4: derating, ratios, disaggregation", model_lines()),
            ("fig4: the wire sweep (Catch on the host's CPU, numpy policy)", wire_lines),
            ("fig4: sharded inference and provisioning", sharded_lines() + provision_lines())]


def wire_sweep(smoke=True, gateways=1, transport="all", telemetry=False):
    """The measured half: the transport sweep (each point under its own
    `Telemetry` with `telemetry`), the best-of-N probe and the model check
    at each probed RTT. Returns (lines, bench, gate_failed); with
    `telemetry`, ``bench["attribution"]`` holds each point's bottleneck."""
    sec = 0.5 if smoke else 1.5
    hosts = max(1 if smoke else 2, gateways)
    wire_transports = {"socket": ("inproc", "socket"), "shm": ("inproc", "shm"),
                       "all": ("inproc", "socket", "shm")}[transport]
    n_act, E = max(2, hosts), 4
    out = [f"# measured: in-proc vs loopback-TCP vs shm-ring (same system; Catch on the "
           f"host's CPU, numpy policy; os.cpu_count() {os.cpu_count()})"]
    t_rows = measured_transport_sweep(num_actors=n_act, envs_per_actor=E, seconds=sec,
                                      num_actor_hosts=hosts, num_gateways=gateways,
                                      transports=wire_transports, telemetry=telemetry)
    bench = {"benchmark": "fig4_wire", "smoke": bool(smoke),
             "num_actors": n_act, "envs_per_actor": E,
             "num_actor_hosts": hosts, "seconds": sec,
             "transports": {}, "ping_rtt_s": {}, "ping_frames_per_s": {},
             "bytes_per_frame": wire_bytes_table(envs_per_actor=E)}
    fps = {}
    for name, stats in t_rows:
        fps[name] = stats["env_frames_per_s"]
        err = stats["inference_error"] or (stats.get("host_errors") or [None])[0]
        shard = ""
        if name in ("socket", "shm"):
            shard = (f" gateways={stats.get('num_gateways', 1)} "
                     f"conns_per_gateway={stats.get('per_gateway_connections')} "
                     f"host_cuda_initialized={stats.get('host_cuda_initialized')}")
        if name == "shm":
            shard += (f" shm_frames={stats.get('host_shm_frames')} "
                      f"spill_frames={stats.get('host_spill_frames')}")
        out.append(f"fig4_transport_{name},{stats['env_frames_per_s']:.1f},"
                   f"frames_per_s occupancy={stats['mean_batch_occupancy']:.2f} "
                   f"queue_wait_ms={stats['mean_queue_wait_ms']:.2f} "
                   f"inference_compute_s={stats['inference_compute_s']:.3f} "
                   f"error={err}{shard}")
        bench["transports"][name] = {
            "env_frames_per_s": stats["env_frames_per_s"],
            "env_frames": stats["env_frames"],
            "actor_iterations": stats["actor_iterations"],
            "mean_batch_occupancy": stats["mean_batch_occupancy"],
            "mean_queue_wait_ms": stats["mean_queue_wait_ms"],
            "inference_compute_s": stats["inference_compute_s"],
            "host_shm_frames": stats.get("host_shm_frames"),
            "host_spill_frames": stats.get("host_spill_frames"),
            "error": err,
        }
        if telemetry and "bottleneck" in stats:
            b_ = stats["bottleneck"]
            bench.setdefault("attribution", {})[name] = b_
            out.append(f"fig4_measured_ratio_{name},{b_['cpu_gpu_ratio']:.2f},"
                       f"{b_['bottleneck']} wire_share={b_['shares'].get('wire', 0.0):.2f}")
    gate_failed = None
    if min(fps.values()) <= 0:
        out.append("fig4_transport_relative,NaN,run_produced_zero_frames")
        gate_failed = "system sweep produced zero frames"
    else:
        for wire_t in wire_transports[1:]:
            out.append(f"fig4_transport_relative_{wire_t},{fps[wire_t] / fps['inproc']:.3f},"
                       f"{wire_t}_over_inproc acceptance>=0.5")
        if "socket" in fps and "shm" in fps:
            out.append(f"fig4_transport_shm_over_tcp,{fps['shm'] / fps['socket']:.3f},"
                       f"system_sweep_single_trial (gate is the best-of-N probe)")
        best, shm_active = measure_wire_ping(envs_per_actor=E, pings=100 if smoke else 200,
                                             trials=3 if smoke else 5)
        for name in ("inproc", "tcp", "shm"):
            bench["ping_rtt_s"][name] = best[name]
            bench["ping_frames_per_s"][name] = E / best[name]
            out.append(f"fig4_ping_{name},{1e6 * best[name]:.1f},us_per_roundtrip best_of_N "
                       f"frames_per_s={E / best[name]:.0f}")
        bench["shm_ring_active"] = bool(shm_active)
        shm_over_tcp = best["tcp"] / best["shm"]
        out.append(f"fig4_ping_shm_over_tcp,{shm_over_tcp:.3f},"
                   f"probe_speedup ring_active={shm_active} acceptance>=1.0")
        if "shm" in wire_transports:
            if not shm_active:
                gate_failed = "CODEC_SHM ring never activated on loopback"
            elif best["shm"] > best["tcp"]:
                gate_failed = (f"shm probe slower than TCP loopback: "
                               f"{1e6 * best['shm']:.1f}us vs {1e6 * best['tcp']:.1f}us "
                               f"(best-of-N)")
        t_probe = {"socket": max(best["tcp"] - best["inproc"], 0.0),
                   "shm": max(best["shm"] - best["inproc"], 0.0)}
        wire_of = {"socket": "tcp", "shm": "shm"}
        for wire_t in wire_transports[1:]:
            t_rtt = t_probe[wire_t]
            _, model_net, ordered = transport_model_check(
                t_rows, n_act, E, t_rtt, wire=wire_of[wire_t], measured_key=wire_t)
            out.append(f"fig4_wire_rtt_ms_{wire_t},{1e3 * t_rtt:.3f},"
                       f"probed_{wire_of[wire_t]}_rtt_minus_inproc")
            out.append(f"fig4_model_network_{wire_t},{model_net:.1f},frames_per_s "
                       f"with_network({1e3 * t_rtt:.2f}ms,wire={wire_of[wire_t]})_prediction "
                       f"measured={fps[wire_t]:.1f} ordering_ok={ordered}")
        bench["shm_over_tcp_probe"] = shm_over_tcp
    if gate_failed and "shm" not in wire_transports:
        gate_failed = None      # the probe gates only the shm plane
    return out, bench, gate_failed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny measured windows (exercise the wire path)")
    ap.add_argument("--gateways", type=int, default=1,
                    help="shard the socket run across G gateways (+ G "
                         "inference replicas); hosts hash across addresses")
    ap.add_argument("--transport", choices=("socket", "shm", "all"), default="all",
                    help="which wire planes to sweep against inproc; 'shm' also turns "
                         "the best-of-N shm-vs-TCP probe into a hard gate (nonzero exit)")
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="where to write the wire benchmark's JSON")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises where there is no card) or cpu")
    ap.add_argument("--telemetry", action="store_true",
                    help="run each transport point under the telemetry plane: print the "
                         "MEASURED bottleneck/CPU-GPU ratio per transport and merge the "
                         "attributions into BENCH_telemetry.json next to --out")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# fig4 on the machine of {name}")
    print("name,value,derived")
    lines, bench, gate_failed = wire_sweep(args.smoke, args.gateways, args.transport,
                                           telemetry=args.telemetry)
    sections = report(lines)
    for title, body in sections[:2]:
        print(f"# {title}")
        print("\n".join(body))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    attribution = bench.pop("attribution", None)
    out.write_text(json.dumps(bench, indent=2, sort_keys=True) + "\n")
    print(f"# wrote {out}")
    if args.telemetry:
        tel_out = out.parent / "BENCH_telemetry.json"
        merge_bench_json(str(tel_out), "fig4_transports", {
            "smoke": bool(args.smoke), "seconds": bench["seconds"],
            "num_actors": bench["num_actors"], "envs_per_actor": bench["envs_per_actor"],
            "attribution": attribution or {}})
        print(f"# merged measured attributions into {tel_out}")
    # trend-guard history: one point per wire transport measured this run
    # (the wire JSON above is replaced wholesale; the history accumulates)
    for wire_t, row in bench["transports"].items():
        if wire_t != "inproc" and row["env_frames_per_s"] > 0:
            append_bench_history(
                str(out.parent / "BENCH_history.json"), f"fig4_{wire_t}",
                {"commit": bench_commit(), "ts": time.time(),
                 "frames_per_s": row["env_frames_per_s"], "smoke": bool(args.smoke)})
    if gate_failed:
        print(f"fig4_shm_gate,FAIL,{gate_failed}")
        sys.exit(1)
    for title, body in sections[2:]:
        print(f"# {title}")
        print("\n".join(body))
    return bench


if __name__ == "__main__":
    main()
