"""The port's telemetry bundle on the CPU, held to the JAX package's.

`repro_torch.telemetry` copies ``repro.telemetry``: the bottleneck
attribution, the `Telemetry.bottleneck_report` arithmetic over the same
counters and CPU totals, the merged snapshot, the sink's files, the flight
recorder's bundles, the heartbeat verdicts and the auditor must come out
the same in both packages on the same inputs. The system tests run the
port's `SeedSystem` with a bundle and check counts, never rates: in
process (host and device backends), and once with two spawned actor hosts
whose spans stitch with the learner's into one trace.
"""

import functools
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.telemetry import Telemetry as JTelemetry  # noqa: E402
from repro.telemetry import audit as jaudit, flightrec as jflightrec  # noqa: E402
from repro.telemetry import health as jhealth, sampler as jsampler, sink as jsink  # noqa: E402
from repro_torch.core.system import SeedSystem  # noqa: E402
from repro_torch.envs.catch import CatchEnv  # noqa: E402
from repro_torch.rollout import DeviceRolloutEngine, RolloutWorker  # noqa: E402
from repro_torch.telemetry import Telemetry  # noqa: E402
from repro_torch.telemetry import audit, flightrec, health, sampler, sink  # noqa: E402

torch.set_num_threads(1)


CPU_CATCH = functools.partial(CatchEnv, device="cpu")


def _catch():
    return CatchEnv(device="cpu")


def det_policy(obs, ids):
    flat = np.abs(obs.reshape(obs.shape[0], -1))
    return (flat.sum(axis=1) * 997.0).astype(np.int64) % CatchEnv.num_actions


# ------------------------------------------------------------- attribution

ATTRIBUTION = {
    "actor": dict(elapsed_s=2.0, frames=1000, actor_cpu_s=3.0, inference_compute_s=0.2,
                  learner_train_s=0.4, wire_overhead_s=0.1),
    "inference": dict(elapsed_s=1.5, frames=77, actor_cpu_s=0.01, inference_compute_s=1.0),
    "learner": dict(elapsed_s=1.0, frames=5, learner_train_s=0.9, actor_cpu_s=0.3),
    "wire": dict(elapsed_s=1.0, frames=400, actor_cpu_s=0.1, wire_overhead_s=0.5),
    "drop_override": dict(elapsed_s=1.0, frames=400, actor_cpu_s=0.9, learner_train_s=0.01,
                          drop_rate=0.75),
    "drop_below_knee": dict(elapsed_s=1.0, frames=400, actor_cpu_s=0.9, drop_rate=0.25),
    "idle_no_frames": dict(elapsed_s=1.0, frames=0, actor_cpu_s=0.9),
    "idle_no_seconds": dict(elapsed_s=1.0, frames=10),
    "detail": dict(elapsed_s=0.5, frames=3, actor_cpu_s=1e-9, inference_compute_s=2e-9,
                   detail={"cpu_cores": {"learner": 0.5}}),
}


@pytest.mark.parametrize("case", sorted(ATTRIBUTION))
def test_attribute_bottleneck_as_the_reference(case):
    got = sampler.attribute_bottleneck(**ATTRIBUTION[case])
    want = jsampler.attribute_bottleneck(**ATTRIBUTION[case])
    assert got.as_dict() == want.as_dict()
    assert str(got) == str(want)


def _counters(tel, *, lanes, batches, rpcs, compute_s, wait_s, train=(), rtt=(), host_rtt=()):
    """The same registry contents in either package's bundle: the server's
    replica counters, the learner's train histogram, the actors' wire
    round trips, and one absorbed actor host carrying its own."""
    reg = tel.metrics
    for r, share in ((0, 0.75), (1, 0.25)):
        reg.counter(f"inference/r{r}/requests").add(lanes * share)
        reg.counter(f"inference/r{r}/batches").add(batches * share)
        reg.counter(f"inference/r{r}/rpcs").add(rpcs * share)
        reg.counter(f"inference/r{r}/compute_s").add(compute_s * share)
        reg.counter(f"inference/r{r}/queue_wait_s").add(wait_s * share)
    for v in train:
        reg.histogram("learner/train_s").record(v)
    for v in rtt:
        reg.histogram("wire/rtt_s").record(v)
    if host_rtt:
        child = type(tel)(process_name="actor-host-0", out_dir="unused")
        for v in host_rtt:
            child.metrics.histogram("wire/rtt_s").record(v)
        child.metrics.counter("host_wire/shm_frames").add(11)
        tel.absorb_host({"host_id": 0, "trace_events": child.tracer.export_events(),
                         "metrics_snapshot": child.metrics.snapshot()})


REPORTS = {
    "inproc_learner_cpu": (dict(lanes=4000, batches=500, rpcs=1000, compute_s=0.8, wait_s=0.3,
                                train=(0.01, 0.02, 0.05)),
                           {"learner": 2.5}, {"env_frames": 3996, "elapsed_s": 2.0}),
    "inproc_net_cpu_below_zero": (dict(lanes=40, batches=5, rpcs=10, compute_s=0.8, wait_s=0.3,
                                       train=(0.5, 0.6)),
                                  {"learner": 0.9}, {"env_frames": 40, "elapsed_s": 1.0}),
    "actor_hosts_and_wire": (dict(lanes=8000, batches=900, rpcs=2000, compute_s=0.4,
                                  wait_s=0.9, rtt=(1e-4, 3e-4), host_rtt=(2e-4, 8e-4, 5e-3)),
                             {"learner": 1.0, "actor-host-0": 3.0, "actor-host-1": 2.5},
                             {"env_frames": 7996, "elapsed_s": 2.0,
                              "onpolicy": {"drop_rate": 0.1}}),
    "learner_drops": (dict(lanes=800, batches=100, rpcs=200, compute_s=0.1, wait_s=0.1,
                           train=(0.2,) * 5),
                      {"learner": 1.0, "actor-host-0": 0.5},
                      {"env_frames": 800, "elapsed_s": 1.0, "onpolicy": {"drop_rate": 0.8}}),
    "no_stats": (dict(lanes=64, batches=8, rpcs=16, compute_s=0.05, wait_s=0.01),
                 {"learner": 0.2}, None),
}


@pytest.mark.parametrize("case", sorted(REPORTS))
def test_bottleneck_report_as_the_reference(case, monkeypatch):
    """`Telemetry.bottleneck_report` on the same registry counters, CPU
    totals and stats: the same report, field for field (the in-process
    formula nets compute and train seconds out of the learner's CPU)."""
    kw, totals, stats = REPORTS[case]
    reports = []
    for cls in (Telemetry, JTelemetry):
        tel = cls(process_name="learner", out_dir="unused")
        _counters(tel, **kw)
        monkeypatch.setattr(tel.sampler, "cpu_totals", lambda: dict(totals))
        reports.append(tel.bottleneck_report(None if stats is None else dict(stats)))
        merged = tel.merged_snapshot()
        reports.append({"counters": merged["counters"], "gauges": merged["gauges"],
                        "histograms": sorted(merged["histograms"])})
    assert reports[0].as_dict() == reports[2].as_dict()
    assert reports[1] == reports[3]
    assert np.isfinite(reports[0].cpu_gpu_ratio)


# ------------------------------------------------------- sink and recorder

def test_sink_files_and_bench_ledgers_as_the_reference(tmp_path):
    events = [{"name": "span", "ph": "X", "pid": 1, "tid": 2, "ts": 3.0, "dur": 4.0}]
    lines = [{"ts": 1.5, "cpu_cores": {"learner": 0.5}, "metrics": {"counters": {"x": 1.0}}},
             {"ts": 2.5, "registry": "gateway0", "metrics": {}}]
    got = sink.TelemetrySink(str(tmp_path / "got")).dump(events, lines)
    want = jsink.TelemetrySink(str(tmp_path / "want")).dump(events, lines)
    for key in ("trace", "metrics"):
        assert open(got[key]).read() == open(want[key]).read()
    assert sink.METRICS_SCHEMA_VERSION == jsink.METRICS_SCHEMA_VERSION
    for mod, name in ((sink, "got"), (jsink, "want")):
        path = str(tmp_path / f"{name}.json")
        mod.merge_bench_json(path, "a", {"x": 1})
        mod.merge_bench_json(path, "b", {"y": [1, 2]})
        mod.merge_bench_json(path, "a", {"x": 2})
        hist = str(tmp_path / f"{name}_hist.json")
        for i in range(5):
            mod.append_bench_history(hist, "fig", {"commit": "c", "frames_per_s": i}, keep=3)
    for a, b in (("got.json", "want.json"), ("got_hist.json", "want_hist.json")):
        assert (tmp_path / a).read_text() == (tmp_path / b).read_text()
    assert json.loads((tmp_path / "got_hist.json").read_text())["fig"][0]["frames_per_s"] == 2
    assert sink.bench_commit()            # never raises, never empty
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


def test_flight_recorder_bundles_as_the_reference(tmp_path):
    names = []
    for mod, name in ((flightrec, "got"), (jflightrec, "want")):
        rec = mod.FlightRecorder(out_dir=str(tmp_path / name), max_bundles=2,
                                 per_reason_cooldown_s=60.0)
        rec.add_provider("metrics", lambda: {"counters": {"x": 1}})
        rec.add_provider("broken", lambda: 1 / 0)
        rec.set_trace_source(lambda: [{"name": "s", "ph": "X", "pid": 1, "tid": 1,
                                       "ts": 0, "dur": 1}], lambda evs: {"traceEvents": evs})
        paths = [rec.trigger("wedge", "detail"), rec.trigger("wedge"), rec.trigger("other"),
                 rec.trigger("third")]
        assert [p is not None for p in paths] == [True, False, True, False]
        assert rec.dropped == 2
        names.append([(os.path.basename(p), sorted(os.listdir(p))) for p in rec.bundles])
        manifest = json.load(open(os.path.join(rec.bundles[0], "manifest.json")))
        assert (manifest["reason"], manifest["detail"], manifest["seq"]) == ("wedge", "detail", 1)
    assert names[0] == names[1]


def test_flight_recorder_keeps_a_bundle_whose_name_is_taken(tmp_path):
    """Two recorders in one directory (an earlier run's, or another
    mode's): the reference's second `host_death` bundle collides with the
    first's name and is lost; the port's lands beside it with a suffix."""
    for mod in (flightrec, jflightrec):
        first = mod.FlightRecorder(out_dir=str(tmp_path / mod.__name__)).trigger("host_death")
        assert first is not None and first.endswith("postmortem-host_death-001")
    got = flightrec.FlightRecorder(out_dir=str(tmp_path / flightrec.__name__))
    want = jflightrec.FlightRecorder(out_dir=str(tmp_path / jflightrec.__name__))
    assert want.trigger("host_death") is None and want.bundles == []
    path = got.trigger("host_death")
    assert path.endswith("postmortem-host_death-001.2") and got.bundles == [path]
    assert json.load(open(os.path.join(path, "manifest.json")))["reason"] == "host_death"


# --------------------------------------------------------- health and audit

def _health_story(mod):
    reg = mod.HeartbeatRegistry(default_stale_after_s=60.0, event_window_s=60.0)
    out = []
    reg.register("slow", stale_after_s=60.0)
    reg.register("info", stale_after_s=None)
    reg.beat("slow")
    reg.beat("actor-host-0")                  # auto-registered, watched
    out.append(reg.report())
    reg.register("never_beaten", stale_after_s=1e-9)
    out.append(reg.report())
    reg.unregister("never_beaten")
    reg.event("auditor", "ledger not conserved")
    out.append(reg.report())
    reg.unregister("slow")
    reg.unregister("actor-host-0")
    out.append(reg.report())
    dog = mod.Watchdog(reg, on_unhealthy=lambda rep: out.append(("fired", rep.verdict)))
    dog.check()
    dog.check()
    out.append(("transitions", dog.transitions))
    return [(r.verdict, r.stale, sorted(r.components), [e["message"] for e in r.events])
            if isinstance(r, mod.HealthReport) else r for r in out]


def test_heartbeat_verdicts_and_watchdog_as_the_reference():
    got, want = _health_story(health), _health_story(jhealth)
    assert got == want
    assert [g[0] if len(g) == 4 else g for g in got][:4] == ["healthy", "degraded",
                                                             "degraded", "degraded"]


def _audit_story(mod, metrics_cls):
    aud = mod.InvariantAuditor()
    state = {"bad": False}
    aud.add_check("ledger", lambda: ["broken"] if state["bad"] else [])
    reg = metrics_cls()
    c = reg.counter("frames")
    c.add(10)
    aud.watch_registry("main", reg)
    out = [aud.tick()]
    state["bad"] = True
    out.append(aud.tick())
    out.append(aud.tick())
    with reg.lock:
        c.value -= 5
    out.append(aud.tick())
    aud.add_check("explodes", lambda: 1 / 0)
    out.append([v.split(":")[0] for v in aud.tick()])
    out.append([(v["check"], v["message"]) for v in aud.violations])
    return out


def test_auditor_as_the_reference():
    from repro.telemetry import MetricsRegistry as JMetricsRegistry
    from repro_torch.telemetry import MetricsRegistry
    assert _audit_story(audit, MetricsRegistry) == _audit_story(jaudit, JMetricsRegistry)


def test_sampler_reads_this_process_and_survives_a_vanished_pid(caplog):
    from repro_torch.telemetry import MetricsRegistry
    cpu = sampler.read_process_cpu_s(os.getpid())
    assert cpu is not None and cpu > 0
    assert sampler.read_process_cpu_s(2 ** 22 + 12345) is None
    s = sampler.UtilizationSampler(MetricsRegistry())
    s.watch("self", os.getpid())
    s.watch("ghost", 2 ** 22 + 12345)
    with caplog.at_level("WARNING", logger="repro_torch.telemetry.sampler"):
        for _ in range(3):
            s.sample()
    assert len([r for r in caplog.records if "ghost" in r.getMessage()]) == 1
    assert "self" in s.cpu_totals() and len(s.ticks) == 3


# --------------------------------------------------------------- the system

def test_inproc_system_under_telemetry_counts_and_reports(tmp_path):
    """Host backend in process: the registry's lane counter is the stats'
    lane count, actor frames trail served lanes by at most the lanes in
    flight, the spans cover actors and replicas, the report is classified
    and finite, and the dump writes both files."""
    tel = Telemetry(process_name="learner", out_dir=str(tmp_path))
    system = SeedSystem(env_factory=_catch, policy_step=det_policy, num_actors=2, unroll=4,
                        envs_per_actor=2, deadline_ms=1.0, telemetry=tel)
    system.warmup()
    stats = system.run(seconds=0.5, with_learner=False)
    assert stats["env_frames"] > 0 and stats["inference_error"] is None
    lanes = tel._counter_total("/requests")
    assert int(lanes) == stats["inference_lanes"]
    assert 0 <= lanes - stats["env_frames"] <= 2 * 2
    b = stats["bottleneck"]
    assert b["bottleneck"].endswith("-bound") and np.isfinite(b["cpu_gpu_ratio"])
    assert b["frames"] == stats["env_frames"] and "learner" in b["detail"]["cpu_cores"]
    names = {e["name"] for e in tel.trace_events() if e.get("ph") == "X"}
    assert names, "no span recorded"
    paths = tel.dump()
    assert json.load(open(paths["trace"]))["traceEvents"]
    assert [json.loads(ln)["tick"] for ln in open(paths["metrics"])][:2] == [0, 1]
    assert "ops_address" not in stats and system.ops_address is None


class _Beats:
    """A HeartbeatRegistry stand-in that records what it is told."""

    def __init__(self):
        self.log = []

    def register(self, name, stale_after_s=None):
        self.log.append(("register", name, stale_after_s))

    def beat(self, name):
        self.log.append(("beat", name))

    def unregister(self, name):
        self.log.append(("unregister", name))


def test_rollout_worker_beats_once_an_unroll_and_unregisters():
    beats = _Beats()
    eng = DeviceRolloutEngine(_catch, lambda p, c, o, g: (torch.zeros(o.shape[0], dtype=torch.long),
                                                          c), 2, 4, seed=1)
    w = RolloutWorker(3, eng, lambda traj: None, lambda: (None, 0), health=beats)
    w.start()
    deadline = time.time() + 20.0
    while w.iterations < 3 and time.time() < deadline:
        time.sleep(0.01)
    w.stop()
    w.join()
    assert w.error is None, w.error
    assert beats.log[0] == ("register", "rollout/worker3", 10.0)
    assert beats.log[-1] == ("unregister", "rollout/worker3")
    n_beats = sum(1 for e in beats.log if e[0] == "beat")
    # one beat before each unroll: those finished, and at most one more
    assert w.iterations <= n_beats <= w.iterations + 1


def test_device_backend_hands_the_workers_the_health_registry(tmp_path):
    tel = Telemetry(process_name="learner", out_dir=str(tmp_path))
    system = SeedSystem(env_factory=_catch, backend="device", num_actors=2, unroll=4,
                        envs_per_actor=2, telemetry=tel,
                        policy_apply=lambda p, c, o, g: (torch.zeros(o.shape[0],
                                                                     dtype=torch.long), c))
    assert [a._health for a in system.actors] == [tel.health, tel.health]
    stats = system.run(seconds=0.3, with_learner=False)
    assert stats["env_frames"] == stats["scans"] * 4 * 2 > 0
    assert "rollout/worker0" not in tel.health.report().components   # unregistered
    assert stats["bottleneck"]["frames"] == stats["env_frames"]


def test_socket_hosts_ship_telemetry_and_stitch_into_one_trace(tmp_path):
    """Two spawned actor hosts under `ActorHostPool(telemetry=True)`: each
    builds its own bundle without a CUDA context, ships its spans and its
    registry home, and the parent's one trace stitches round trips across
    the processes by the wire-carried trace_seq; the sampler measured the
    children's CPU from /proc, their heartbeats were relayed and closed."""
    tel = Telemetry(process_name="learner", out_dir=str(tmp_path))
    system = SeedSystem(env_factory=CPU_CATCH, policy_step=det_policy, num_actors=2,
                        unroll=4, envs_per_actor=2, deadline_ms=2.0, transport="socket",
                        num_actor_hosts=2, telemetry=tel)
    assert system.pool.telemetry is True
    stats = system.run(seconds=1.5, with_learner=False)
    assert stats["host_errors"] == [] and stats["env_frames"] > 0
    assert stats["host_cuda_initialized"] == [False, False]
    assert all("trace_events" not in s for s in system.pool.last_stats)   # absorbed
    events = tel.trace_events()
    pids_by_seq = {}
    for e in events:
        seq = (e.get("args") or {}).get("trace_seq")
        if e.get("ph") == "X" and seq:
            pids_by_seq.setdefault(seq, set()).add(e["pid"])
    assert any(len(p) >= 2 for p in pids_by_seq.values())
    assert len({e["pid"] for e in events}) >= 3
    assert any(e.get("ph") in ("s", "f") for e in events)          # flow arrows
    totals = tel.sampler.cpu_totals()
    assert {"actor-host-0", "actor-host-1"} <= set(totals)
    assert tel.merged_snapshot()["counters"].get("host_wire/spill_frames", 0) == 0
    assert "actor-host-0" not in tel.health.report().components     # closed
    rep = tel.bottleneck_report(stats)
    assert rep.frames == stats["env_frames"] and np.isfinite(rep.cpu_gpu_ratio)
    assert rep.detail["actor_cpu_s"] == pytest.approx(
        totals["actor-host-0"] + totals["actor-host-1"])
