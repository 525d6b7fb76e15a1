"""The port's measurement surfaces on the CPU, held to the reference's
benchmark scripts: Figs 2, 3 and 4 (``src/repro_torch/benchmarks/``) and
the provisioning tool (``repro_torch.launch.provision_system``).

Every model row equals the reference script's function on the same
inputs, within 1e-12 relative (the reference scripts are loaded by path);
the rows where the port prints this machine with one H100 in place of the
reference's TPU host are held to the reference's functions fed the H100's
fields. The measured functions run at tiny windows on the CPU and are
checked on their ledgers, never on rates. The card's side runs in
``chip_smoke.py``'s phase 18.
"""

import dataclasses
import importlib.util
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import hw as jhw  # noqa: E402
from repro.core import bottleneck as jb, provisioning as jp  # noqa: E402
from repro_torch.benchmarks import fig2_breakdown as fig2  # noqa: E402
from repro_torch.benchmarks import fig3_actor_scaling as fig3  # noqa: E402
from repro_torch.benchmarks import fig4_cpu_gpu_ratio as fig4  # noqa: E402
from repro_torch.benchmarks import run as bench_run  # noqa: E402
from repro_torch.hw import H100_SXM, HostSpec, h100_host  # noqa: E402
from repro_torch.launch import provision_system  # noqa: E402
from repro_torch.launch.actor_host import OPS_ITEM  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-12
WINDOW_S = 0.3


def _load(path):
    spec = importlib.util.spec_from_file_location(f"ref_{Path(path).stem}", ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    return {"fig2": _load("benchmarks/fig2_breakdown.py"),
            "fig3": _load("benchmarks/fig3_actor_scaling.py"),
            "fig4": _load("benchmarks/fig4_cpu_gpu_ratio.py"),
            "provision": _load("examples/provision_system.py")}


def close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=REL, atol=0)


def jchip(chip):
    return jhw.ChipSpec(**dataclasses.asdict(chip))


def jhost(host):
    return jhw.HostSpec(**dataclasses.asdict(host))


# -- Fig 3's model rows ------------------------------------------------------------

def test_fig3_model_sweep_and_checks_equal_reference(ref):
    tm, terr, tsw = fig3.model_sweep()
    jm, jerr, jsw = ref["fig3"].model_sweep()
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm) and terr == jerr
    assert [n for n, _ in tsw] == [n for n, _ in jsw]
    close([s for _, s in tsw], [s for _, s in jsw])
    s40, s256_40 = fig3.fig3b_checks(tsw)
    close([s40, s256_40], [dict(jsw)[40], dict(jsw)[256] / dict(jsw)[40]])
    assert abs(s40 - 5.8) / 5.8 <= 1e-9 and abs(s256_40 - 2.0) / 2.0 <= 1e-9


@pytest.mark.parametrize("fn", ["model_env_sweep", "model_backend_sweep",
                                "model_replica_sweep"])
def test_fig3_model_rows_equal_reference(ref, fn):
    got, want = getattr(fig3, fn)(), getattr(ref["fig3"], fn)()
    assert [r[0] for r in got] == [r[0] for r in want]
    close([r[1] for r in got], [r[1] for r in want])
    for kw in ({"n_actors": 8}, {"n_actors": 256}):
        got, want = getattr(fig3, fn)(**kw), getattr(ref["fig3"], fn)(**kw)
        close([r[1] for r in got], [r[1] for r in want])


def test_fig3f_model_rows_equal_reference(ref):
    for kw in ({}, {"learner_step_s": 2.0, "batch_size": 4, "unroll": 8}):
        got, want = fig3.model_vtrace_sweep(**kw), ref["fig3"].model_vtrace_sweep(**kw)
        assert [n for n, _ in got] == [n for n, _ in want]
        for (_, t), (_, j) in zip(got, want):
            assert t.learner_bound == j.learner_bound
            close(dataclasses.astuple(t)[:-1], dataclasses.astuple(j)[:-1])


def test_fig3_perf_per_watt_equals_reference_formula(ref):
    """The reference computes it inline in its main (``:1071-1077``)."""
    _, _, sw = ref["fig3"].model_sweep()
    want = []
    for n, s in sw:
        util = min(1.0, s / max(x for _, x in sw))
        power = jhw.V100.idle_power_w + (jhw.V100.peak_power_w - jhw.V100.idle_power_w) * util
        want.append((n, s / power * 100, power))
    got = fig3.perf_per_watt(fig3.model_sweep()[2])
    assert [r[0] for r in got] == [r[0] for r in want]
    close([r[1:] for r in got], [r[1:] for r in want])


@pytest.mark.parametrize("t_dev", [(0.0667, 2.94e-6), (0.05, 0.002), (1.3, 4e-4)])
def test_fig3d_card_row_is_the_reference_model_at_measured_costs(t_dev):
    jm, _ = jp.fit_paper_actor_model()
    want = float(jm.with_envs(8).with_device(*t_dev).throughput(40))
    got, over = fig3.model_device_card(*t_dev)
    close(got, want)
    close(over, want / float(jm.with_envs(8).throughput(40)))


def test_fit_t_dev_recovers_a_line():
    lanes = (8, 64, 512, 4096)
    t_dev0, t_dev1, unroll, t_env = 38.81e-6, 1.712e-9, 16, 5.82e-4
    replay_ms = [(t_dev0 + t_dev1 * e) * unroll * 1e3 for e in lanes]
    fit = fig3.fit_t_dev(lanes, replay_ms, unroll, t_env)
    assert fit["t_dev0_s"] == pytest.approx(t_dev0, rel=1e-9)
    assert fit["t_dev1_s"] == pytest.approx(t_dev1, rel=1e-9)
    assert fit["t_dev0_in_t_env"] == pytest.approx(t_dev0 / t_env, rel=1e-9)
    assert fit["residual_max_s"] < 1e-15
    lines = fig3.lines_3d_model(fit, "test")
    assert lines[-1].startswith("fig3d_model_device_resident_card,")
    assert len(lines) == 4
    for part in (f"t_dev0={t_dev0:.4e}s", f"t_dev1={t_dev1:.4e}s", f"t_env={t_env:.4e}s",
                 "median of 1 trials"):
        assert part in lines[-1], part


def test_measure_t_dev_on_the_cpu():
    seen = []
    fit = fig3.measure_t_dev("cpu", lanes=(8, 64), iters=5,
                             each=lambda e, eng: seen.append(e) or {"lanes_seen": e})
    assert set(fit["sweep"]) == {8, 64} and seen == [8, 64]
    for e, row in fit["sweep"].items():
        assert math.isfinite(row["replay_ms"]) and row["replay_ms"] > 0
        assert row["lanes_seen"] == e and row["host_limited"] is None
    assert math.isfinite(fit["t_dev0_s"]) and math.isfinite(fit["t_dev1_s"])
    assert len(fit["t_env_trials_s"]) == 5
    assert fit["t_env_s"] == float(np.median(fit["t_env_trials_s"])) > 0
    assert fig3.lines_3d_model(fit, "cpu")[-1].startswith("fig3d_model_device_resident_card,")


def test_device_ms_on_the_cpu():
    from repro_torch.benchmarks.timing import device_ms

    calls = []
    ms, host_limited = device_ms(lambda: calls.append(1), iters=7, warmup=2, device="cpu")
    assert len(calls) == 9 and ms >= 0 and host_limited is None


def test_fig3_report_sections_are_the_line_functions():
    a = [dict(actors=n, envs_per_actor=1, env_frames_per_s=100.0 * n, mean_batch_occupancy=1.0,
              mean_queue_wait_ms=0.1, inference_compute_s=0.01) for n in (1, 2)]
    c = [dict(r, actors=2, envs_per_actor=E) for r, E in zip(a, (1, 4))]
    d = [dict(name=name, envs_per_actor=E, env_frames_per_s=f) for name, E, f in
         (("per_step_host", 1, 800.0), ("vectorized_host", 8, 7000.0),
          ("device_resident", 8, 150000.0))]
    fit = fig3.fit_t_dev((8, 4096), [0.62, 0.73], 16, 4e-4)
    e = [dict(a[0], replicas=R, replica_lanes=[2] * R) for R in (1, 2)]
    shards = [dict(engine_shards=k, env_frames_per_s=1e5 / k) for k in (1, 2)]
    f = [dict(actors=1, gen_frames_per_s=1400.0, trained_frames_per_s=1395.0, drop_rate=0.0,
              mean_param_lag=1.0, mean_trained_lag=1.0, learner_steps=3, learner_train_s=3.7,
              learner_wait_s=1.0, inference_compute_s=0.2)]
    rows = dict(a=a, c=c, d=d, t_dev=fit, e=e, shards=shards, f=f)
    sections = fig3.report(rows, "test card", "cuda")
    want = [fig3.lines_3a(a), fig3.lines_3b(), fig3.lines_3c(c), fig3.lines_3c_model(),
            fig3.lines_3d(d), fig3.lines_3d_model(fit, "test card"), fig3.lines_3e(e),
            fig3.lines_3e_shards(shards), fig3.lines_3e_model(), fig3.lines_ppw(),
            fig3.lines_3f(f), fig3.lines_3f_model()]
    assert [lines for _, lines in sections] == want
    assert [lines for _, lines in fig3.report({"f": f}, "x", "cpu")] == want[-2:]
    fig3.check_measured(a + c + d + e + shards + f)


def test_fig3_and_fig4_share_one_catch_policy():
    obs = np.random.default_rng(0).random((5, 50)).astype(np.float32)
    ids = np.arange(5)
    assert np.array_equal(fig3.busy_policy(obs, ids), fig4.catch_policy(obs, ids))
    assert np.array_equal(fig4.catch_policy(obs, ids), fig4.catch_policy(obs, ids[::-1]))


def test_fig4_report_sections():
    wire = ["fig4_transport_inproc,1.0,frames_per_s"]
    sections = fig4.report(wire)
    assert [lines for _, lines in sections] == [
        fig4.model_lines(), wire, fig4.sharded_lines() + fig4.provision_lines()]


# -- Fig 3's measured functions, tiny windows on the CPU -----------------------------

def _check_ledger(rows, lanes_of):
    for r in rows:
        assert r["env_frames"] > 0 and r["env_frames_per_s"] > 0, r
        assert r["env_frames"] == r["actor_iterations"] * lanes_of(r), r
        assert r["inference_error"] is None, r
        assert all(math.isfinite(r[k]) for k in ("inference_compute_s", "mean_queue_wait_ms"))
    fig3.check_measured(rows)


def test_fig3a_and_3c_measured_on_the_host():
    a = fig3.measured_sweep(actor_counts=(1, 2), seconds=WINDOW_S, step_cost=256)
    assert [r["actors"] for r in a] == [1, 2]
    c = fig3.measured_env_sweep(env_counts=(1, 2), seconds=WINDOW_S, step_cost=256)
    assert [r["envs_per_actor"] for r in c] == [1, 2] and all(r["actors"] == 2 for r in c)
    _check_ledger(a + c, lambda r: r["envs_per_actor"])
    for r in a + c:         # no learner runs in these parts
        assert r["learner_train_s"] is None and r["learner_wait_s"] is None
    assert len(fig3.lines_3a(a)) == 2 and "learner_train_s=none" in fig3.lines_3a(a)[0]
    assert fig3.lines_3c(c)[1].startswith("fig3c_envs_2,")


def test_fig3e_replicas_measured_on_the_cpu():
    rows = fig3.measured_replica_sweep(replica_counts=(1, 2), seconds=WINDOW_S, device="cpu")
    _check_ledger(rows, lambda r: r["envs_per_actor"])
    assert [r["replicas"] for r in rows] == [1, 2]
    assert len(rows[1]["replica_lanes"]) == 2
    assert [ln.split(",")[0] for ln in fig3.lines_3e(rows)] == ["fig3e_replicas_1",
                                                               "fig3e_replicas_2"]


def test_fig3f_measured_rows_carry_learner_seconds():
    rows = fig3.measured_vtrace_sweep(actor_counts=(1,), seconds=0.8, device="cpu")
    (r,) = rows
    assert r["learner_steps"] > 0 and r["gen_frames_per_s"] > 0
    assert r["learner_train_s"] > 0 and math.isfinite(r["learner_wait_s"])
    assert r["env_frames"] == r["actor_iterations"] * fig3.VTRACE["envs_per_actor"]
    assert "learner_train_s=" in fig3.lines_3f(rows)[0]


def test_fig3_cli_smoke_on_the_cpu(capsys):
    out = fig3.main(["--smoke", "--device", "cpu"])
    text = capsys.readouterr().out
    for name in ("fig3a_actors_2", "fig3b_check_4to40", "fig3c_envs_4", "fig3d_device_resident",
                 "fig3d_model_device_resident_card", "fig3e_replicas_2",
                 "fig3e_engine_shards_2", "fig3e_model_replicas_8", "fig3b_perf_per_watt_256"):
        assert re.search(rf"^{name},", text, re.M), name
    _check_ledger(out["d"][:2], lambda r: r["envs_per_actor"])


# -- Fig 4 ---------------------------------------------------------------------------

def test_fig4_model_rows_equal_reference(ref):
    jd = jp.fit_paper_derating()
    got = fig4.derating_rows()
    close([s for _, s in got], [float(jd.slowdown(sms / 80.0)) for sms, _ in got])
    assert [sms for sms, _ in got] == [80, 64, 40, 20, 8, 2]
    host = HostSpec("h100-host", 8, 1500.0)
    ratios = dict(fig4.ratio_rows(host))
    close([ratios["dgx1"], ratios["dgx_a100"], ratios["h100_host_1chip"]],
          [jp.cpu_gpu_ratio(jhw.DGX1_HOST, jhw.V100, 8),
           256 / (8 * 108 * (312e12 / 108) / (125e12 / 80)),
           jp.cpu_gpu_ratio(jhost(host), jchip(H100_SXM), 1)])
    close([t for _, t in fig4.disaggregated_rows()],
          [jp.cpu_gpu_ratio_breakdown([jhw.DGX1_HOST] * k, jhw.V100, 8).total
           for k in (1, 2, 4, 8, 16)])
    jm, _ = jp.fit_paper_actor_model()
    jnet = jm.with_network(0.2, n_hosts=4)
    close([s for _, s in fig4.sharded_rows()],
          [float(jnet.with_sharded(R).throughput(160)) / float(jnet.throughput(160))
           for R in (1, 2, 4, 8)])
    close(fig4.replica_ratio_rows(),
          jp.cpu_gpu_ratio_breakdown([jhw.DGX1_HOST] * 3, jhw.V100, 8, n_replicas=2).per_replica)
    for (name, p), (want_name, flops) in zip(fig4.provision_rows(host),
                                             (("r2d2_atari_2M", 2e6), ("lm_policy_1B", 2e9),
                                              ("lm_policy_32B_active", 6.4e10))):
        j = jp.provision(jchip(H100_SXM), jhost(host), 1, train_flops_per_frame=6 * flops,
                         infer_flops_per_frame=2 * flops, mfu=0.4)
        assert name == want_name and p.balanced == j.balanced
        close(dataclasses.astuple(p)[:-1], dataclasses.astuple(j)[:-1])


@pytest.mark.parametrize("E", [1, 4, 8])
def test_wire_bytes_table_equals_reference(ref, E):
    assert fig4.wire_bytes_table(E) == ref["fig4"].wire_bytes_table(E)


def _stats(fps):
    return {"env_frames_per_s": fps}


@pytest.mark.parametrize("seed", range(4))
def test_transport_model_check_equals_reference(ref, seed):
    rng = np.random.default_rng(seed)
    rows = [(t, _stats(float(rng.uniform(100, 20000)))) for t in ("inproc", "socket", "shm")]
    for key, wire in (("socket", "tcp"), ("shm", "shm")):
        n, E, rtt = int(rng.integers(1, 8)), int(rng.integers(1, 16)), float(rng.uniform(0, 1e-3))
        got = fig4.transport_model_check(rows, n, E, rtt, wire=wire, measured_key=key)
        want = ref["fig4"].transport_model_check(rows, n, E, rtt, wire=wire, measured_key=key)
        close(got[:2], want[:2])
        assert got[2] == want[2]


def test_fig4_inproc_point_and_ping_on_the_cpu():
    rows = fig4.measured_transport_sweep(num_actors=2, envs_per_actor=4, seconds=WINDOW_S,
                                         transports=("inproc",))
    ((name, stats),) = rows
    assert name == "inproc" and stats["inference_error"] is None
    assert 0 < stats["env_frames"] == stats["actor_iterations"] * 4
    assert fig4.CPU_CATCH().device.type == "cpu"
    best, _ = fig4.measure_wire_ping(envs_per_actor=4, pings=20, trials=1)
    assert set(best) == {"tcp", "shm", "inproc"} and all(v > 0 for v in best.values())


def test_fig4_wire_sweep_spawns_cpu_actor_hosts(tmp_path, capsys):
    """The one test here that spawns actor hosts: the CLI at its smoke
    windows over shm, each host stepping Catch on its CPU."""
    out = tmp_path / "wire.json"
    try:
        bench = fig4.main(["--smoke", "--transport", "shm", "--device", "cpu",
                           "--out", str(out)])
    except SystemExit as e:            # the reference's hard shm-probe gate
        assert e.code == 1
        assert "fig4_shm_gate,FAIL" in capsys.readouterr().out
        bench = None
    assert out.is_file()
    import json
    bench = bench or json.loads(out.read_text())
    for name in ("inproc", "shm"):
        row = bench["transports"][name]
        assert row["error"] is None and row["env_frames"] > 0
        assert row["env_frames"] == row["actor_iterations"] * bench["envs_per_actor"]
    assert bench["bytes_per_frame"] == fig4.wire_bytes_table(bench["envs_per_actor"])


# -- Fig 2 ---------------------------------------------------------------------------

def test_fig2_paper_rows_equal_reference(ref):
    t, j = fig2.r2d2_paper_terms(), ref["fig2"].r2d2_paper_terms()
    close(dataclasses.astuple(t), dataclasses.astuple(j))
    want = jb.sequential_idealization(j)
    for k, v, p in fig2.paper_rows():
        close(v, want[k])
        assert p == jb.paper_fig2_reference().get(k, 0.0)


@pytest.mark.parametrize("flops,counted_ms,busy_ms,wall_ms",
                         [(6.53e11, 30.0, 60.9, 108.4), (1.6e12, 40.0, 59.72, 152.01),
                          (1e9, 0.5, 1.0, 2.0), (1e6, 0.3, 0.3, 150.0),
                          (6.53e11, 60.9, 60.9, 60.9)])
def test_fig2_card_row_shares_sum_to_one(flops, counted_ms, busy_ms, wall_ms):
    nbytes = fig2.step_bytes(fig2.AtariConfig(), 64)
    row = fig2.card_row(flops, nbytes, wall_ms / 1e3, busy_ms / 1e3, counted_ms / 1e3)
    shares = row["shares"]
    assert set(shares) == {"math", "occupancy", "memory", "collective", "uncounted", "other"}
    assert all(math.isfinite(v) and v >= 0 for v in shares.values())
    assert sum(shares.values()) == pytest.approx(1.0, abs=1e-12)
    assert 0 < row["occupancy"] <= 1.0
    assert shares["other"] == pytest.approx(1 - busy_ms / wall_ms, rel=1e-12, abs=1e-15)
    assert shares["uncounted"] == pytest.approx((busy_ms - counted_ms) / wall_ms, abs=1e-15)
    terms = jb.RooflineTerms(row["compute_s"], row["memory_s"], 0.0, row["occupancy"])
    ideal = jb.sequential_idealization(terms)
    close([shares[k] for k in ("math", "occupancy", "memory")],
          [ideal[k] * counted_ms / wall_ms for k in ("math", "occupancy", "memory")])
    # the derate makes the terms the counted kernels' time
    assert row["model_s"] == pytest.approx(counted_ms / 1e3, rel=1e-12)


@pytest.mark.parametrize("flops,counted_ms,busy_ms,wall_ms,why", [
    (6.53e11, 30.0, 400.0, 300.0, "busy beyond the wall"),
    (6.53e11, 70.0, 60.9, 108.4, "counted beyond busy"),
    (6.53e11, 0.0, 60.9, 108.4, "no counted time"),
    (6.53e11, 9.0, 60.9, 108.4, "FLOPs do not fit at the peak rate"),
    (0.0, 30.0, 60.9, 108.4, "no FLOPs counted")],
    ids=["busy-over-wall", "counted-over-busy", "no-counted", "flops-over-peak", "no-flops"])
def test_fig2_card_row_refuses_readings_that_cannot_be(flops, counted_ms, busy_ms, wall_ms, why):
    nbytes = fig2.step_bytes(fig2.AtariConfig(), 64)
    with pytest.raises(ValueError):
        fig2.card_row(flops, nbytes, wall_ms / 1e3, busy_ms / 1e3, counted_ms / 1e3)


@pytest.mark.parametrize("name,group", [
    ("void cudnn::cnn::conv2d_grouped_direct_kernel", "conv"),
    ("sm90_xmma_fprop_implicit_gemm_f32f32", "conv"), ("aten::convolution_backward", "conv"),
    ("ampere_sgemm_128x64_tn", "gemm"), ("nvjet_tst_64x8_64x16", "gemm"),
    ("aten::addmm", "gemm"), ("aten::mm", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4, sigmoid>", "lstm_gates"),
    ("aten::tanh_backward", "lstm_gates"), ("aten::add_", "other"),
    ("void at::native::reduce_kernel<512, 1>", "other")])
def test_fig2_kernel_groups(name, group):
    assert fig2.kernel_group(name) == group


def test_fig2_busy_groups_count_each_instant_once():
    spans = [("aten::convolution", 0.0, 10.0), ("aten::_convolution", 2.0, 8.0),
             ("aten::empty", 3.0, 4.0), ("aten::addmm", 12.0, 15.0),
             ("aten::sigmoid", 20.0, 21.0), ("aten::add_", 14.0, 16.0)]
    g = fig2.busy_groups_s(spans)
    close([g["conv"], g["gemm"], g["lstm_gates"], g["other"]], [10e-6, 3e-6, 1e-6, 3e-6])
    close([g["counted"], g["busy"]], [13e-6, 15e-6])


def test_fig2_step_bytes_is_the_reference_formula_at_its_shapes():
    acfg = fig2.AtariConfig()
    assert fig2.step_bytes(acfg.__class__(burn_in=0, unroll=80), 64) == \
        64 * 80 * (84 * 84 * 4 + 4 * 512 * 4) * 3.0
    assert fig2.step_bytes(acfg, 64) == 64 * 120 * (84 * 84 * 4 + 4 * 512 * 4) * 3.0


def test_fig2_card_row_from_the_reduced_agent_on_the_cpu():
    train_step, state, batch = fig2.build_r2d2_step(fig2.SMOKE_AGENT, 2, "cpu")
    flops, state = fig2.step_flops(train_step, state, batch)
    assert flops > 0 and state["step"] == 1
    wall, groups, state = fig2.measure_step(train_step, state, batch, warm=1, timed=2)
    assert state["step"] == 5 and wall > 0
    assert 0 < groups["counted"] <= groups["busy"] <= wall
    row = fig2.card_row(flops, fig2.step_bytes(fig2.SMOKE_AGENT, 2), wall, groups["busy"],
                        groups["counted"])
    assert all(math.isfinite(v) and v >= 0 for v in row["shares"].values())
    assert sum(row["shares"].values()) == pytest.approx(1.0, abs=1e-12)
    lines = fig2.card_lines(row, "cpu")
    assert [ln.split(",")[0] for ln in lines[:6]] == [
        f"fig2_card_r2d2_{k}"
        for k in ("math", "occupancy", "memory", "collective", "uncounted", "other")]


# -- provision_system and run.py ---------------------------------------------------------

def _numbers(line):
    return [float(x) for x in re.findall(r"-?\d+\.?\d*(?:e[-+]?\d+)?", line)]


def test_provision_system_rows_equal_reference(ref, capsys):
    """Line by line, every number of the shared sections equals the
    reference's printed one; the H100 lines are the reference's functions
    on the H100's fields."""
    ref["provision"].main()
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    host = HostSpec("h100-host", 8, 1500.0)
    got = [ln for ln in "\n".join(provision_system.report(host)).splitlines() if ln.strip()]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if "v5e" in w or "H100" in g or "this machine" in g:
            continue
        if w.startswith("   ") and "demand" in w:      # the v5e-8 provisioning rows
            continue
        assert _numbers(g) == _numbers(w), (g, w)
    j_ratio = jp.cpu_gpu_ratio(jhost(host), jchip(H100_SXM), 1)
    assert f"{j_ratio:.4f}" in next(g for g in got if "H100 host" in g)
    demand = [g for g in got if "demand" in g]
    for g, (_, n_params) in zip(demand, provision_system.WORKLOADS):
        j = jp.provision(jchip(H100_SXM), jhost(host), 1, train_flops_per_frame=6 * n_params,
                         infer_flops_per_frame=2 * n_params, mfu=0.4)
        assert f"{j.frames_demand_per_s:10.0f}" in g
        assert ("balanced" in g) == j.balanced


def test_provision_system_needs_no_card(capsys):
    lines = provision_system.main()
    assert capsys.readouterr().out.splitlines()[0] == lines[0]
    assert any(f"{h100_host().hw_threads} host threads" in ln for ln in lines)
    assert any(ln.startswith("   DGX-1") for ln in lines)


def test_microbench_on_the_cpu(capsys):
    bench_run.microbench_train_step("cpu", n=2)
    text = capsys.readouterr().out
    assert re.search(r"^train_step_tiny_qwen3,\d+,tokens_per_s=\d+$", text, re.M)
    assert re.search(r"^serve_step_tiny_qwen3,\d+,decode_tokens_per_s=\d+$", text, re.M)


# -- refusals and the device ----------------------------------------------------------------

@pytest.mark.parametrize("mod,flag", [(fig3, "--telemetry"), (fig3, "--chaos"),
                                      (fig3, "--autoscale"), (fig4, "--telemetry")],
                         ids=["fig3-telemetry", "fig3-chaos", "fig3-autoscale", "fig4-telemetry"])
def test_ops_modes_refuse_naming_the_roadmap_item(mod, flag):
    with pytest.raises(SystemExit) as err:
        mod.main([flag, "--device", "cpu"])
    assert OPS_ITEM in str(err.value) and "queue 1" in str(err.value)
    assert "Ops and survival planes" in OPS_ITEM


@pytest.mark.parametrize("mod", [fig2, fig3, fig4, bench_run],
                         ids=["fig2", "fig3", "fig4", "run"])
def test_entry_points_raise_without_a_card(mod):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        mod.main(["--smoke"])
