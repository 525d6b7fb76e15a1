"""The port's closed loop on the CPU, held to the JAX package's.

`repro_torch.autoscale` and the time-series and SLO modules it reads are
copies of the reference's: the same points give the same queries and the
same SLO verdicts, the same `PolicyInputs` sequences give the same
decisions (a hypothesis sweep over bottleneck classes, churn, topology and
SLO burn), and two controllers over stub actuators log the same entries.
The system tests check counts and ledgers, never rates: the controller
armed in process, and one run whose elastic pool grows a spawned actor
host and drains one mid-window with the frame ledger exactly conserved.
"""

import functools
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import repro.autoscale as J  # noqa: E402
from repro.telemetry import Telemetry as JTelemetry  # noqa: E402
from repro.telemetry import slo as jslo, timeseries as jts  # noqa: E402
import repro_torch.autoscale as P  # noqa: E402
from repro_torch.core.system import SeedSystem  # noqa: E402
from repro_torch.envs.alesim import FlatSimEnv  # noqa: E402
from repro_torch.envs.catch import CatchEnv  # noqa: E402
from repro_torch.onpolicy import VTraceLearner, mlp_actor_critic  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.telemetry import Telemetry  # noqa: E402
from repro_torch.telemetry import slo, timeseries  # noqa: E402

torch.set_num_threads(1)


# ------------------------------------------------------ series and SLOs

def _store(mod, seed, n=40):
    """A store with a counter, a falling gauge and a noisy gauge sampled
    at jittered times, from `seed`."""
    rng = np.random.default_rng(seed)
    s = mod.TimeSeriesStore(capacity=32)
    t, frames = 0.0, 0.0
    for _ in range(n):
        t += float(rng.uniform(0.1, 0.6))
        frames += float(rng.integers(0, 300))
        s.record("frames_generated", frames, t=t)
        s.record("drop_rate", float(rng.random()), t=t)
        s.record("infer_p99_ms", float(rng.uniform(0, 40)), t=t)
    return s, t


def _dump(store):
    """`TimeSeriesStore.dump` over every point, less its wall-clock stamp."""
    doc = store.dump(window_s=1e9)
    doc.pop("now")
    return doc


SLOS = [dict(name="frames_floor", series="frames_generated", target=350.0, kind="floor",
             mode="rate", fast_window_s=2.0, slow_window_s=6.0),
        dict(name="drop_rate", series="drop_rate", target=0.5, kind="ceiling",
             fast_window_s=1.0, slow_window_s=4.0),
        dict(name="p99", series="infer_p99_ms", target=20.0, burn_threshold=0.3,
             min_points=5),
        dict(name="empty", series="no_such_series", target=1.0)]


@pytest.mark.parametrize("seed", range(5))
def test_timeseries_and_slo_verdicts_as_the_reference(seed):
    (got, t), (want, _) = _store(timeseries, seed), _store(jts, seed)
    for name in ("frames_generated", "drop_rate", "infer_p99_ms", "absent"):
        for w in (0.5, 2.0, 30.0):
            for q in ("rate", "derivative", "mean"):
                assert getattr(got, q)(name, w, now=t) == getattr(want, q)(name, w, now=t)
            assert got.ewma(name, w, now=t) == want.ewma(name, w, now=t)
        assert got.latest(name) == want.latest(name)
    assert _dump(got) == _dump(want)
    for now in (t, t + 3.0):
        g = slo.SLOSet([slo.SLO(**kw) for kw in SLOS]).evaluate(got, now)
        w = jslo.SLOSet([jslo.SLO(**kw) for kw in SLOS]).evaluate(want, now)
        assert {k: v.as_dict() for k, v in g.items()} == {k: v.as_dict() for k, v in w.items()}


@pytest.mark.parametrize("kw", [dict(kind="sideways"), dict(mode="median"),
                                dict(fast_window_s=5.0, slow_window_s=1.0),
                                dict(burn_threshold=0.0)])
def test_slo_validation_as_the_reference(kw):
    args = dict(name="x", series="y", target=1.0, **kw)
    with pytest.raises(ValueError) as want:
        jslo.SLO(**args)
    with pytest.raises(ValueError) as got:
        slo.SLO(**args)
    assert str(got.value) == str(want.value)


def test_store_sources_and_capacity_as_the_reference():
    outs = []
    for mod in (timeseries, jts):
        s = mod.TimeSeriesStore(capacity=4)
        s.add_source(lambda: {"a": 1.0, "b": 2.0})
        s.add_source(lambda: 1 / 0)                    # a bad source is skipped
        for i in range(6):
            s.sample(now=float(i))
        outs.append((s.names(), _dump(s), len(s.series("a").window(100.0, 5.0))))
        with pytest.raises(ValueError):
            mod.TimeSeriesStore(capacity=1)
    assert outs[0] == outs[1]


# ------------------------------------------------------------- the policy

BOTTLENECKS = ("actor-bound", "inference-bound", "learner-bound", "wire-bound", "idle",
               "unknown")

tick = st.tuples(st.sampled_from(BOTTLENECKS), st.floats(0.05, 2.0),
                 st.sampled_from([0.0, 0.0, 0.0, 0.7]), st.integers(1, 5), st.integers(1, 4),
                 st.booleans())


@settings(max_examples=60, deadline=None)
@given(cfg=st.fixed_dictionaries({
    "min_hosts": st.integers(1, 2), "max_hosts": st.integers(2, 5),
    "max_replicas": st.sampled_from([None, 2, 3]), "grow_after_ticks": st.integers(1, 3),
    "shrink_after_ticks": st.integers(1, 4), "cooldown_s": st.sampled_from([0.0, 0.5, 2.0])}),
    ticks=st.lists(tick, min_size=1, max_size=25))
def test_policy_decisions_as_the_reference(cfg, ticks):
    """Both policies, one `AutoscaleConfig` each from the same draw, fed
    the same tick sequence: every Action equal, field for field."""
    got, want = P.AutoscalePolicy(P.AutoscaleConfig(**cfg)), J.AutoscalePolicy(
        J.AutoscaleConfig(**cfg))
    now = 0.0
    for bottleneck, dt, churn, hosts, replicas, drop_burning in ticks:
        now += dt
        verdicts = {}
        for mod, key in ((slo, "p"), (jslo, "j")):
            verdicts[key] = {"drop_rate": mod.SLOVerdict(
                name="drop_rate", ok=not drop_burning, burning=drop_burning,
                fast_fraction=1.0, slow_fraction=1.0, value=0.9, target=0.5, kind="ceiling")}
        common = dict(now=now, bottleneck=bottleneck, churn_rate=churn, hosts=hosts,
                      replicas_active=replicas, replicas_max=3)
        a = got.decide(P.PolicyInputs(verdicts=verdicts["p"], **common))
        b = want.decide(J.PolicyInputs(verdicts=verdicts["j"], **common))
        assert a.as_dict() == b.as_dict()


@pytest.mark.parametrize("kw", [dict(interval_s=0.0), dict(min_hosts=3, max_hosts=2),
                                dict(min_replicas=0), dict(min_replicas=2, max_replicas=1),
                                dict(grow_after_ticks=0), dict(cooldown_s=-1.0)])
def test_autoscale_config_validation_as_the_reference(kw):
    with pytest.raises(ValueError) as want:
        J.AutoscaleConfig(**kw)
    with pytest.raises(ValueError) as got:
        P.AutoscaleConfig(**kw)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------- the controller

class _StubPool:
    def __init__(self, hosts=1):
        self.hosts, self.grows, self.drains = hosts, 0, 0

    def live_hosts(self):
        return self.hosts

    def request_grow(self):
        self.grows += 1
        self.hosts += 1
        return True

    def request_drain(self):
        self.drains += 1
        self.hosts -= 1
        return True


class _StubServer:
    def __init__(self, num_replicas=3, active=1):
        self.num_replicas, self.active_replicas = num_replicas, active

    def set_active_replicas(self, n):
        self.active_replicas = max(1, min(int(n), self.num_replicas))
        return self.active_replicas


class _Report:
    def __init__(self, b):
        self.bottleneck, self.cpu_gpu_ratio, self.shares = b, 1.5, {"actor": 0.9}


def _controller(pkg, tel_cls, classes, **cfg):
    tel = tel_cls(process_name="test-autoscale", out_dir="unused")
    it = iter(classes)
    tel.bottleneck_report = lambda stats: _Report(next(it))
    c = pkg.AutoscaleController(
        pkg.AutoscaleConfig(**{**dict(grow_after_ticks=1, cooldown_s=0.0, max_hosts=3), **cfg}),
        tel, stats_fn=lambda: {"elapsed_s": 1.0, "env_frames": 100},
        pool=_StubPool(), server=_StubServer())
    frames = iter(range(0, 10 ** 6, 250))
    c.store.add_source(lambda: {"frames_generated": float(next(frames)),
                                "recovery/host_restarts": 0.0})
    return c


@pytest.mark.parametrize("dry_run", [False, True])
def test_controller_ticks_log_as_the_reference(dry_run):
    """Two controllers over stub actuators and the same bottleneck classes
    tick by tick: the same decision log (wall time aside), applied
    actions, topology and dump; grows stop at the host cap."""
    classes = ["actor-bound"] * 4 + ["inference-bound"] * 3 + ["learner-bound", "idle"]
    got = _controller(P, Telemetry, classes, dry_run=dry_run)
    want = _controller(J, JTelemetry, classes, dry_run=dry_run)
    for i in range(len(classes)):
        a, b = got.tick(now=float(i)), want.tick(now=float(i))
        a.pop("ts"), b.pop("ts")
        assert a == b
    assert got.actions_applied == want.actions_applied
    assert got.topology() == want.topology()
    d_got, d_want = got.dump(), want.dump()
    for d in (d_got, d_want):
        d.pop("uptime_s")
        for e in d["decisions"]["entries"]:
            e.pop("ts", None)          # the ticks' entries are these very dicts
    assert d_got == d_want
    if not dry_run:
        assert got.actions_applied == {"grow_hosts": 2, "grow_replicas": 2}
        assert got.pool.hosts == 3 and got.server.active_replicas == 3


def test_seedsystem_autoscale_validation_as_the_reference():
    with pytest.raises(TypeError, match="AutoscaleConfig"):
        SeedSystem(env_factory=CatchEnv, policy_step=lambda o, i: None, num_actors=1, unroll=4,
                   autoscale={"max_hosts": 2})
    with pytest.raises(ValueError, match="backend"):
        SeedSystem(env_factory=CatchEnv, backend="device", policy_apply=lambda *a: None,
                   num_actors=1, unroll=4, autoscale=P.AutoscaleConfig())


def test_armed_controller_in_process_logs_annotated_holds(tmp_path):
    """`SeedSystem(autoscale=...)` in process: a default bundle is built,
    the controller ticks through the run sensing the live series, a grow
    has no pool to act on and is logged as an annotated hold, and
    /autoscaler and /timeseries serve its documents."""
    system = SeedSystem(env_factory=lambda: CatchEnv(device="cpu"),
                        policy_step=lambda o, i: np.zeros(o.shape[0], np.int64), num_actors=2,
                        unroll=4, envs_per_actor=2, deadline_ms=1.0, ops_port=0,
                        autoscale=P.AutoscaleConfig(interval_s=0.05, grow_after_ticks=1,
                                                    cooldown_s=0.0))
    assert isinstance(system.telemetry, Telemetry) and system.autoscaler is not None
    assert system.autoscaler.pool is None and system.autoscaler.server is system.server
    system.warmup()
    try:
        stats = system.run(seconds=0.6, with_learner=False)
        entries = system.autoscaler.log.entries()
        assert len(entries) == system.autoscaler.ticks >= 3
        grows = [e for e in entries if e["action"]["kind"] == "grow_hosts"]
        assert all(not e["applied"] and "no actor-host pool" in e["note"] for e in grows)
        assert "frames_generated" in system.autoscaler.store.names()
        assert system.autoscaler.store.latest("frames_generated") <= stats["inference_lanes"]
        varz = system._varz()
        assert varz["schema_version"] == 2 and varz["autoscale"]["ticks"] >= 3
        assert system.telemetry.ops.autoscaler()["enabled"] is True
        assert "frames_generated" in system.telemetry.ops.timeseries(30.0)["series"]
    finally:
        system.stop_ops()


def test_elastic_pool_grows_and_drains_with_the_ledger_exact():
    """A V-trace socket run whose pool is elastic (a dry-run controller
    arms the seams without acting): one grow and one drain by hand, mid
    window. Both count, the grown host's actor ids sit above the
    constructed ones, and frames stay exactly conserved, none pending."""
    obs_dim = FlatSimEnv().obs_dim
    init_fn, apply_fn = mlp_actor_critic(obs_dim, FlatSimEnv.num_actions)
    vl = VTraceLearner(apply_fn, adamw(1e-3))
    params = init_fn(torch.Generator().manual_seed(0), "cpu")
    state = vl.init_state(params)
    policy = vl.sampling_policy(params)
    system = SeedSystem(env_factory=functools.partial(FlatSimEnv, step_cost=256),
                        policy_step=policy, num_actors=2, unroll=8, envs_per_actor=2,
                        deadline_ms=2.0, algo="vtrace", train_step=vl.train_step, state=state,
                        learner_batch=2, max_param_lag=10 ** 6, policy_publish=policy.publish,
                        transport="socket", num_actor_hosts=1,
                        autoscale=P.AutoscaleConfig(interval_s=0.25, dry_run=True))
    assert system.pool.elastic
    done = {}

    def drive():
        deadline = time.perf_counter() + 30.0
        while time.perf_counter() < deadline \
                and system.onpolicy_queue.stats()["frames_generated"] == 0:
            time.sleep(0.05)
        done["grow"] = system.pool.request_grow()
        time.sleep(2.5)
        done["drain"] = system.pool.request_drain()

    driver = threading.Thread(target=drive, daemon=True)
    driver.start()
    stats = system.run(seconds=6.0)
    driver.join(timeout=1.0)
    assert done == {"grow": True, "drain": True}
    assert stats["host_errors"] == [], stats["host_errors"]
    assert (stats["hosts_grown"], stats["hosts_drained"]) == (1, 1)
    assert system.pool.hw_actors == 4 and len(system.pool.last_stats) == 2
    assert any(s.get("drained") for s in system.pool.last_stats)
    assert stats["host_cuda_initialized"] == [False, False]
    onp = stats["onpolicy"]
    assert onp["frames_generated"] == onp["frames_trained"] + onp["frames_dropped"] \
        + onp["frames_pending"]
    assert onp["frames_pending"] == 0 and onp["frames_generated"] > 0
    assert system.server.num_slots <= system.pool.hw_actors * 2
    assert all(e["applied"] is False for e in system.autoscaler.log.entries())
