"""The port's analysis machinery held to the JAX package's: `hw`,
`core/provisioning.py`, `core/bottleneck.py` and `configs/shapes.py`.

The port keeps copies of the reference's pure-numpy models, so every
quantity must equal the reference's on the same inputs within 1e-12
relative, over seeded grids of actors, lanes, round trips, replicas and
hosts; their validation errors must match too. The H100 rows are held by
building the reference's `ChipSpec` from `H100_SXM`'s fields. Then the
reference's own model tests (``tests/test_system.py``,
``tests/test_rollout.py``, ``tests/test_onpolicy.py``,
``tests/test_sharding.py``, ``tests/test_vector_env.py``), run on the port.
"""

import dataclasses
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import hw as jhw  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.core import bottleneck as jb, provisioning as jp  # noqa: E402
from repro_torch import hw  # noqa: E402
from repro_torch.configs import SHAPES, InputShape, shape_cells  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.core import bottleneck as tb, provisioning as tp  # noqa: E402
from repro_torch.hw import DGX1_HOST, H100_SXM, V100, h100_host  # noqa: E402

REL = 1e-12
RNG = np.random.default_rng(0)
ACTORS = np.concatenate([np.arange(1, 65), RNG.integers(65, 5000, 64),
                         RNG.uniform(0.5, 300.0, 32)])


def jchip(chip):
    return jhw.ChipSpec(**dataclasses.asdict(chip))


def jhost(host):
    return jhw.HostSpec(**dataclasses.asdict(host))


def close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=REL, atol=0)


def fitted():
    (tm, terr), (jm, jerr) = tp.fit_paper_actor_model(), jp.fit_paper_actor_model()
    return tm, jm


# -- hw ------------------------------------------------------------------------

def test_paper_constants_equal_the_reference():
    assert dataclasses.asdict(V100) == dataclasses.asdict(jhw.V100)
    assert dataclasses.asdict(DGX1_HOST) == dataclasses.asdict(jhw.DGX1_HOST)
    for chip in (V100, H100_SXM):
        close(hw.sm_equivalents(chip), jhw.sm_equivalents(jchip(chip)))
        close(hw.sm_equivalents(chip, 1e12), jhw.sm_equivalents(jchip(chip), 1e12))


def test_h100_and_its_host_replace_the_tpu():
    assert (H100_SXM.peak_bf16_flops, H100_SXM.hbm_bandwidth, H100_SXM.ici_bandwidth,
            H100_SXM.ici_links, H100_SXM.hbm_bytes, H100_SXM.peak_power_w) == \
        (989.4e12, 3.35e12, 25e9, 18, 80e9, 700.0)
    assert 0 < H100_SXM.idle_power_w < H100_SXM.peak_power_w
    assert hw.sm_equivalents(H100_SXM) == pytest.approx(633.216)
    host = h100_host()
    assert host.hw_threads == len(os.sched_getaffinity(0))
    assert host.env_steps_per_thread_s == jhw.V5E_HOST.env_steps_per_thread_s == 1500.0
    assert not [n for n in vars(hw) if "tpu" in n.lower() or "v5e" in n.lower()]


# -- the actor model -----------------------------------------------------------

def test_fit_paper_actor_model_equals_reference():
    (tm, terr), (jm, jerr) = tp.fit_paper_actor_model(), jp.fit_paper_actor_model()
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert terr == jerr
    for kw in ({"hw_threads": 8}, {"hw_threads": 112, "target_5p8": 4.0},
               {"target_2p0": 3.0}):
        (tm, terr), (jm, jerr) = tp.fit_paper_actor_model(**kw), jp.fit_paper_actor_model(**kw)
        assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
        close(terr, jerr)


POINTS = {
    "base": lambda m: m,
    "envs_8": lambda m: m.with_envs(8),
    "device_default": lambda m: m.with_envs(8).with_device(),
    "device_card": lambda m: m.with_envs(8).with_device(0.0667, 2.94e-6),
    "network_tcp_4_hosts": lambda m: m.with_envs(4).with_network(0.2, n_hosts=4),
    "network_shm": lambda m: m.with_network(0.05, wire="shm"),
    "sharded_4": lambda m: m.with_sharded(4),
    "network_sharded": lambda m: m.with_network(0.2, n_hosts=4).with_sharded(8),
}


@pytest.mark.parametrize("point", sorted(POINTS))
def test_operating_points_equal_reference(point):
    tm, jm = fitted()
    t, j = POINTS[point](tm), POINTS[point](jm)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    close(t.throughput(ACTORS), j.throughput(ACTORS))
    for base in (1, 4, 40):
        close(t.speedup(ACTORS, base), j.speedup(ACTORS, base))


@pytest.mark.parametrize("seed", range(6))
def test_random_operating_points_equal_reference(seed):
    rng = np.random.default_rng(seed)
    tm, jm = fitted()
    E = int(rng.choice([1, 2, 4, 8, 16, 64]))
    rtt = float(rng.uniform(0.0, 2.0))
    hosts = int(rng.choice([1, 2, 4, 16]))
    R = int(rng.choice([1, 2, 3, 4, 8, 64]))
    t0, t1 = float(rng.uniform(0.0, 0.2)), float(rng.uniform(1e-7, 1e-2))
    wire = str(rng.choice(["tcp", "shm"]))
    for build in (lambda m: m.with_envs(E),
                  lambda m: m.with_envs(E).with_device(t0, t1),
                  lambda m: m.with_envs(E).with_network(rtt, n_hosts=hosts, wire=wire),
                  lambda m: m.with_envs(E).with_sharded(R),
                  lambda m: m.with_envs(E).with_network(rtt, n_hosts=hosts).with_sharded(R)):
        t, j = build(tm), build(jm)
        close(t.throughput(ACTORS), j.throughput(ACTORS))
        close(t.speedup(ACTORS), j.speedup(ACTORS))
    raw = dict(t_env=float(rng.uniform(1e-4, 1e-2)), t_inf0=float(rng.uniform(0, 1e-2)),
               t_inf1=float(rng.uniform(0, 1e-4)), hw_threads=int(rng.integers(1, 256)),
               batch_cap=int(rng.integers(64, 512)), envs_per_actor=E)
    close(tp.SystemModel(**raw).throughput(ACTORS), jp.SystemModel(**raw).throughput(ACTORS))


@pytest.mark.parametrize("seed", range(4))
def test_onpolicy_point_equals_reference(seed):
    rng = np.random.default_rng(100 + seed)
    tm, jm = fitted()
    E = int(rng.choice([1, 4, 8]))
    for n in rng.integers(1, 512, 16):
        kw = dict(learner_step_s=float(rng.uniform(0.1, 20.0)),
                  batch_size=int(rng.integers(1, 64)), unroll=int(rng.integers(1, 100)),
                  queue_capacity=int(rng.integers(1, 256)))
        t = tm.with_envs(E).onpolicy_point(int(n), **kw)
        j = jm.with_envs(E).onpolicy_point(int(n), **kw)
        tv, jv = dataclasses.astuple(t), dataclasses.astuple(j)
        assert tv[-1] == jv[-1]                       # learner_bound
        close(tv[:-1], jv[:-1])


def test_derating_equals_reference():
    f = np.concatenate([np.arange(1, 81) / 80.0, RNG.uniform(0.01, 1.0, 32)])
    for s in (1.06, 1.2, 1.01):
        t, j = tp.fit_paper_derating(s), jp.fit_paper_derating(s)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        for E in (1, 2, 8, 64):
            close(t.with_envs(E).slowdown(f), j.with_envs(E).slowdown(f))
    raw = dict(overlap_s=0.7, accel_s=0.3, envs_per_actor=4)
    close(tp.DeratingModel(**raw).slowdown(f), jp.DeratingModel(**raw).slowdown(f))


# -- the ratio and provisioning --------------------------------------------------

@pytest.mark.parametrize("chip", [V100, H100_SXM], ids=lambda c: c.name)
def test_ratios_and_breakdowns_equal_reference(chip):
    hosts = [DGX1_HOST, h100_host(), hw.HostSpec("odd", 7, 900.0)]
    for host in hosts:
        for n in (1, 2, 8):
            close(tp.cpu_gpu_ratio(host, chip, n), jp.cpu_gpu_ratio(jhost(host), jchip(chip), n))
    for k in (1, 2, 3, 16):
        for R in (1, 2, 3, 4):
            chosen = [hosts[i % 3] for i in range(k)]
            t = tp.cpu_gpu_ratio_breakdown(chosen, chip, 8, n_replicas=R)
            j = jp.cpu_gpu_ratio_breakdown([jhost(h) for h in chosen], jchip(chip), 8,
                                           n_replicas=R)
            close(t.total, j.total)
            close(t.sm_equivalents, j.sm_equivalents)
            assert [h[:2] for h in t.per_host] == [h[:2] for h in j.per_host]
            close([h[2] for h in t.per_host], [h[2] for h in j.per_host])
            assert len(t.per_replica) == len(j.per_replica)
            for a, b in zip(t.per_replica, j.per_replica):
                close(a, b)


@pytest.mark.parametrize("chip", [V100, H100_SXM], ids=lambda c: c.name)
def test_provision_equals_reference(chip):
    rng = np.random.default_rng(7)
    for host in (DGX1_HOST, h100_host()):
        for _ in range(16):
            n = int(rng.choice([1, 2, 8]))
            kw = dict(train_flops_per_frame=float(10 ** rng.uniform(6, 11)),
                      infer_flops_per_frame=float(10 ** rng.uniform(6, 11)),
                      mfu=float(rng.uniform(0.05, 0.9)), replay_ratio=float(rng.uniform(0.5, 8)))
            t = tp.provision(chip, host, n, **kw)
            j = jp.provision(jchip(chip), jhost(host), n, **kw)
            assert t.balanced == j.balanced
            close(dataclasses.astuple(t)[:-1], dataclasses.astuple(j)[:-1])


def test_h100_host_provisioning_reads_as_measured():
    """The card's machine through the rule: 8 threads give a ratio of
    8/633.2; the 2 M-param R2D2 policy asks for 16490 threads."""
    host = hw.HostSpec("h100-host", 8, 1500.0)
    assert tp.cpu_gpu_ratio(host, H100_SXM, 1) == pytest.approx(8 / 633.216, rel=REL)
    p = tp.provision(H100_SXM, host, 1, train_flops_per_frame=12e6, infer_flops_per_frame=4e6)
    assert p.threads_required == pytest.approx(16490.0, rel=REL) and not p.balanced


# -- the bottleneck attribution --------------------------------------------------

@pytest.mark.parametrize("overlap", ["serial", "perfect"])
def test_terms_and_idealization_equal_reference(overlap):
    rng = np.random.default_rng(3)
    for chip in (V100, H100_SXM):
        for _ in range(32):
            args = (float(10 ** rng.uniform(9, 15)), float(10 ** rng.uniform(6, 11)),
                    float(rng.choice([0.0, 10 ** rng.uniform(4, 9)])), int(rng.choice([1, 8])))
            occ = float(rng.uniform(0.05, 1.0))
            t = tb.terms_from_hlo(*args, chip, occupancy=occ)
            j = jb.terms_from_hlo(*args, jchip(chip), occupancy=occ)
            close(dataclasses.astuple(t), dataclasses.astuple(j))
            close(t.effective_compute_s, j.effective_compute_s)
            close(t.total(overlap), j.total(overlap))
            assert t.dominant() == j.dominant()
            ts, js = tb.sequential_idealization(t, overlap), jb.sequential_idealization(j, overlap)
            assert ts.keys() == js.keys()
            close([ts[k] for k in ts], [js[k] for k in ts])
    assert tb.paper_fig2_reference() == jb.paper_fig2_reference()


# -- validation errors -----------------------------------------------------------

ERRORS = {
    "negative_rtt": lambda pkg, m: m.with_network(-1.0),
    "zero_hosts": lambda pkg, m: m.with_network(0.1, n_hosts=0),
    "unknown_wire": lambda pkg, m: m.with_network(0.1, wire="udp"),
    "zero_replicas": lambda pkg, m: m.with_sharded(0),
    "float_replicas": lambda pkg, m: m.with_sharded(2.0),
    "replicas_past_cap": lambda pkg, m: m.with_sharded(m.batch_cap + 1),
    "device_sharded": lambda pkg, m: m.with_device().with_sharded(2),
    "device_no_t_dev1": lambda pkg, m: pkg.SystemModel(1.0, 0.0, 0.0, 8,
                                                       backend="device").throughput(4),
    "zero_learner_step": lambda pkg, m: m.onpolicy_point(4, learner_step_s=0.0, batch_size=8,
                                                         unroll=20),
    "zero_batch": lambda pkg, m: m.onpolicy_point(4, learner_step_s=1.0, batch_size=0,
                                                  unroll=20),
    "no_hosts": lambda pkg, m: pkg.cpu_gpu_ratio_breakdown([], None),
    "zero_breakdown_replicas": lambda pkg, m: pkg.cpu_gpu_ratio_breakdown([DGX1_HOST], V100,
                                                                        n_replicas=0),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_validation_errors_match_reference(case):
    tm, jm = fitted()
    with pytest.raises(ValueError) as t_err:
        ERRORS[case](tp, tm)
    with pytest.raises(ValueError) as j_err:
        ERRORS[case](jp, jm)
    assert str(t_err.value) == str(j_err.value)


# -- shapes ----------------------------------------------------------------------

def test_shapes_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    assert tshapes.LONG_CONTEXT_ARCHS == jshapes.LONG_CONTEXT_ARCHS
    for arch in ("qwen3-14b", "mamba2-2.7b", "recurrentgemma-2b", "gemma2-9b"):
        assert shape_cells(arch) == jshapes.shape_cells(arch)
    assert InputShape is tshapes.InputShape


# -- the reference's own model tests, on the port ---------------------------------

def test_actor_model_reproduces_paper_fig3():
    model, err = tp.fit_paper_actor_model()
    assert err < 0.05
    assert model.speedup(40, 4) == pytest.approx(5.8, rel=0.1)
    assert (model.throughput(256) / model.throughput(40)) == pytest.approx(2.0, rel=0.1)
    assert model.throughput(512) < 1.05 * model.hw_threads / model.t_env


def test_derating_reproduces_paper_fig4():
    m = tp.fit_paper_derating()
    assert m.slowdown(0.5) == pytest.approx(1.06, abs=1e-6)
    assert m.slowdown(1.0) == 1.0
    assert m.slowdown(2 / 80) > 2.0
    assert m.envs_per_actor == 1
    assert m.with_envs(8).slowdown(0.5) < m.slowdown(0.5)


def test_cpu_gpu_ratio_matches_paper_examples():
    assert tp.cpu_gpu_ratio(DGX1_HOST, V100, n_chips=8) == pytest.approx(1 / 16)


def test_with_network_is_a_fourth_operating_point():
    model, _ = tp.fit_paper_actor_model()
    net = model.with_network(t_rtt=0.5)
    assert float(net.throughput(40)) < float(model.throughput(40))
    assert float(model.with_network(0.0).throughput(40)) == pytest.approx(
        float(model.throughput(40)))
    assert float(net.throughput(512)) <= float(model.with_network(0.5, n_hosts=4).throughput(512))
    assert float(model.with_network(0.5, n_hosts=4).throughput(2048)) == pytest.approx(
        4 * model.hw_threads / model.t_env)


def test_cpu_gpu_ratio_breakdown_decomposes_per_host():
    one = tp.cpu_gpu_ratio_breakdown([DGX1_HOST], V100, n_chips=8)
    assert one.total == pytest.approx(tp.cpu_gpu_ratio(DGX1_HOST, V100, 8))
    many = tp.cpu_gpu_ratio_breakdown([DGX1_HOST] * 16, V100, n_chips=8)
    assert many.total == pytest.approx(1.0)
    assert len(many.per_host) == 16
    assert sum(c for _, _, c in many.per_host) == pytest.approx(many.total)
    mixed = tp.cpu_gpu_ratio_breakdown([DGX1_HOST, h100_host()], V100, n_chips=8)
    assert mixed.total == pytest.approx(
        tp.cpu_gpu_ratio(DGX1_HOST, V100, 8) + tp.cpu_gpu_ratio(h100_host(), V100, 8))


def test_provisioning_rule_on_the_h100():
    host = h100_host()
    small = tp.provision(H100_SXM, host, 1, train_flops_per_frame=2e6 * 6,
                         infer_flops_per_frame=2e6 * 2)
    big = tp.provision(H100_SXM, host, 1, train_flops_per_frame=3e9 * 6,
                       infer_flops_per_frame=3e9 * 2)
    assert small.frames_demand_per_s > big.frames_demand_per_s
    assert not small.balanced
    assert big.threads_required < small.threads_required


def test_sequential_idealization_sums_to_one():
    terms = tb.RooflineTerms(compute_s=0.5, memory_s=0.2, collective_s=0.3, occupancy=0.8)
    out = tb.sequential_idealization(terms)
    assert out["collective"] + out["memory"] + out["occupancy"] + out["math"] == \
        pytest.approx(1.0)
    assert out["math"] == pytest.approx(0.5 / terms.total())
    assert tb.paper_fig2_reference()["math"] == 0.57


@pytest.mark.parametrize("t_dev", [(0.05, 0.002), (0.0667, 2.94e-6)], ids=["guessed", "card"])
def test_system_model_device_operating_point(t_dev):
    model, _ = tp.fit_paper_actor_model()
    dev = model.with_envs(8).with_device(*t_dev)
    assert float(dev.throughput(40)) > float(model.with_envs(8).throughput(40))
    assert float(dev.throughput(40)) > float(model.throughput(40))
    assert float(dev.throughput(256)) > model.hw_threads / model.t_env
    assert float(dev.throughput(1e9)) <= 1.0 / dev.t_dev1 + 1e-6


def test_system_model_envs_axis():
    model, _ = tp.fit_paper_actor_model()
    assert model.envs_per_actor == 1
    assert float(model.with_envs(8).throughput(8)) > float(model.throughput(8))
    cap = model.hw_threads / model.t_env
    assert float(model.with_envs(64).throughput(10_000)) <= cap * (1 + 1e-9)
    ts = [float(model.with_envs(E).throughput(4)) for E in (1, 2, 4, 8, 16)]
    assert all(b >= a for a, b in zip(ts, ts[1:]))


def test_system_model_onpolicy_operating_point():
    model, _ = tp.fit_paper_actor_model()
    kw = dict(learner_step_s=8.0, batch_size=8, unroll=20, queue_capacity=64)
    below, at, above = (model.onpolicy_point(n, **kw) for n in (16, 40, 256))
    assert below.drop_rate == 0.0 and not below.learner_bound
    assert below.mean_param_lag == pytest.approx(1.0)
    assert above.learner_bound and above.drop_rate > 0.3
    assert above.mean_param_lag == pytest.approx(64 / 8)
    assert above.frames_trained_per_s == pytest.approx(at.frames_trained_per_s, rel=0.2)
    assert above.frames_generated_per_s > at.frames_trained_per_s
