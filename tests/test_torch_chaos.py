"""The port's chaos monkey on the CPU, held to the JAX package's.

`repro_torch.fault.chaos` copies ``repro.fault.chaos``: a seed gives the
same schedule in both packages, events validate alike, and each injection
drives the seam the real failure would use. In process: a wedged replica
flips /healthz to degraded naming it while its sibling keeps serving, and
a crashed learner step is resumed from the live checkpoints with the
params bit-exact and the ledger conserved. One test spawns actor hosts: a
host SIGKILLed through `ActorHostPool.kill_host` and a gateway connection
severed, under supervision and reconnect, with the frame ledger exact.
Every check is on counts, verdicts and ledgers, never on rates.
"""

import functools
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.fault import chaos as jchaos  # noqa: E402
from repro_torch.checkpoint.ckpt import restore_pytree  # noqa: E402
from repro_torch.core.system import SeedSystem  # noqa: E402
from repro_torch.envs.catch import CatchEnv  # noqa: E402
from repro_torch.fault import (ACTIONS, BackoffPolicy, ChaosEvent, ChaosMonkey,  # noqa: E402
                               SimulatedFailure)
from repro_torch.onpolicy import VTraceLearner, mlp_actor_critic  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.telemetry import Telemetry  # noqa: E402

torch.set_num_threads(1)

CPU_CATCH = functools.partial(CatchEnv, device="cpu")


def _http_get(url, timeout=5.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _events(monkey):
    return [(e.at_s, e.action, e.target, e.duration_s) for e in monkey.events]


@pytest.mark.parametrize("seed,horizon,n,actions", [
    (7, 10.0, 4, None), (8, 10.0, 4, None), (0, 3.0, 9, None),
    (123, 60.0, 16, ("kill_actor_host", "sever_gateway_conn")),
    (5, 0.5, 1, ("wedge_replica",))])
def test_random_schedule_as_the_reference(seed, horizon, n, actions):
    kw = {} if actions is None else {"actions": actions}
    got = ChaosMonkey.random(seed=seed, horizon_s=horizon, n_events=n, **kw)
    want = jchaos.ChaosMonkey.random(seed=seed, horizon_s=horizon, n_events=n, **kw)
    assert _events(got) == _events(want)
    assert _events(got) == sorted(_events(got))
    assert ACTIONS == jchaos.ACTIONS
    scripted = ChaosMonkey.scripted(ChaosEvent(2.0, "wedge_replica"),
                                    ChaosEvent(0.5, "kill_actor_host", target=1))
    assert [e.action for e in scripted.events] == ["kill_actor_host", "wedge_replica"]


@pytest.mark.parametrize("args", [(0.5, "explode_sun"), (-1.0, "kill_actor_host")])
def test_chaos_event_validation_as_the_reference(args):
    with pytest.raises(ValueError) as want:
        jchaos.ChaosEvent(*args)
    with pytest.raises(ValueError) as got:
        ChaosEvent(*args)
    assert str(got.value) == str(want.value)


def test_injections_without_their_seam_are_recorded_not_raised():
    """In process there is no pool and no gateway: both injections fail
    into `injected` with their reason, and a second start is refused."""
    system = SeedSystem(env_factory=CPU_CATCH, policy_step=lambda o, i: None, num_actors=1,
                        unroll=4)
    monkey = ChaosMonkey.scripted(ChaosEvent(0.0, "kill_actor_host"),
                                  ChaosEvent(0.0, "sever_gateway_conn"),
                                  ChaosEvent(0.0, "crash_learner_step"))
    monkey.start(system)
    with pytest.raises(RuntimeError, match="already started"):
        monkey.start(system)
    deadline = time.time() + 5.0
    while len(monkey.injected) < 3 and time.time() < deadline:
        time.sleep(0.01)
    monkey.stop()
    assert [(i[1].action, i[2]) for i in monkey.injected] == [
        ("kill_actor_host", False), ("sever_gateway_conn", False), ("crash_learner_step", False)]
    assert "wire transports only" in monkey.injected[0][3]
    assert "no learner" in monkey.injected[2][3]


def test_wedged_replica_flips_healthz_and_its_sibling_serves(tmp_path):
    """`wedge_replica` stalls replica 1 once for 2.5 s: /healthz turns
    degraded naming ``inference/replica1`` (its heartbeat is stale past
    1.5 s), replica 0 keeps serving through the wedge, the watchdog files
    a postmortem, and the real policy is back in place afterwards."""
    def policy(obs, ids):
        return np.zeros(obs.shape[0], np.int64)
    tel = Telemetry(process_name="learner", out_dir=str(tmp_path))
    system = SeedSystem(env_factory=CPU_CATCH, policy_step=policy, num_actors=2, unroll=8,
                        envs_per_actor=2, deadline_ms=1.0, num_replicas=2, telemetry=tel,
                        ops_port=0)
    base = "http://%s:%d" % system.ops_address
    system.warmup()
    monkey = ChaosMonkey.scripted(ChaosEvent(0.3, "wedge_replica", target=1, duration_s=2.5))
    seen, r0 = [], []
    runner = threading.Thread(target=lambda: system.run(seconds=4.0, with_learner=False),
                              daemon=True)
    runner.start()
    try:
        monkey.start(system)
        deadline = time.perf_counter() + 3.5
        while time.perf_counter() < deadline:
            status, hz = _http_get(base + "/healthz")
            rep = json.loads(hz)
            seen.append((status, rep["verdict"], tuple(rep["stale"])))
            r0.append(tel.metrics.snapshot()["counters"].get("inference/r0/batches", 0))
            time.sleep(0.1)
    finally:
        runner.join(timeout=15.0)
        monkey.stop()
        system.stop_ops()
    assert not runner.is_alive()
    assert monkey.injected and monkey.injected[0][2], monkey.injected
    assert (503, "degraded", ("inference/replica1",)) in seen, seen
    assert all("inference/replica0" not in s[2] for s in seen)
    stale_at = [i for i, s in enumerate(seen) if s[2]]
    assert r0[stale_at[-1]] > r0[stale_at[0]], "replica 0 stopped serving in the wedge"
    assert any("watchdog_degraded" in b for b in tel.flightrec.bundles)
    assert system.server.policy_step is policy


def _vtrace(lanes, batch):
    obs_dim = 50
    init_fn, apply_fn = mlp_actor_critic(obs_dim, CatchEnv.num_actions)
    vl = VTraceLearner(apply_fn, adamw(1e-3))
    params = init_fn(torch.Generator().manual_seed(0), "cpu")
    state = vl.init_state(params)
    policy = vl.sampling_policy(params)
    for n in lanes:
        policy(np.zeros((n, obs_dim), np.float32), None)
    vl.warmup(state, batch_size=batch, unroll=8, obs_shape=(obs_dim,))
    return vl, state, policy


def test_crashed_learner_resumes_from_checkpoint_bit_exact(tmp_path):
    """`crash_learner_step` kills the learner thread with a
    `SimulatedFailure`; `resume()` restores the last live-loop checkpoint
    bit for bit, keeps the version monotonic, and the resumed run trains
    with the frame ledger conserved across the crash."""
    vl, state, policy = _vtrace((4, 8), 4)
    system = SeedSystem(env_factory=CPU_CATCH, policy_step=policy, num_actors=2, unroll=8,
                        envs_per_actor=4, deadline_ms=1.0, algo="vtrace",
                        train_step=vl.train_step, state=state, learner_batch=4,
                        policy_publish=policy.publish, checkpoint_dir=str(tmp_path / "ck"),
                        checkpoint_every=1)
    system.warmup()
    monkey = ChaosMonkey.scripted(ChaosEvent(0.6, "crash_learner_step"))
    monkey.start(system)
    stats = system.run(seconds=1.5)
    monkey.stop()
    assert monkey.injected and monkey.injected[0][2], monkey.injected
    assert SimulatedFailure.__name__ in stats["learner_error"]
    before = stats["learner_steps"]
    assert before > 0
    mgr = system._ckpt
    mgr.wait()
    latest = mgr.latest_step()
    expected = restore_pytree(system.learner.state, mgr._step_dir(latest))
    version = system.resume()
    assert version >= before >= latest and system._version() == version
    for k, v in expected["params"].items():
        assert torch.equal(system.learner.state["params"][k], v)
    assert system.throughput(1.0)["recovery"]["checkpoint_restores"] == 1
    stats2 = system.run(seconds=1.0)
    assert stats2["learner_error"] is None and stats2["learner_steps"] > version
    onp = stats2["onpolicy"]
    assert onp["frames_generated"] == onp["frames_trained"] + onp["frames_dropped"]
    assert onp["frames_pending"] == 0


def test_killed_host_and_severed_gateway_survive_with_an_exact_ledger(tmp_path):
    """The chaos run of Fig 3h at a test's size: V-trace over the socket,
    2 hosts behind 2 gateways, supervision and reconnect armed. Once both
    hosts beat, host 0 is SIGKILLed (`kill_host`) and host 1's connection
    severed: the host is respawned, the client reconnects, /healthz saw
    the death, a host_death postmortem exists, no host errored or opened
    CUDA, and generated == trained + dropped + pending with none pending."""
    vl, state, policy = _vtrace((4, 8), 4)
    tel = Telemetry(process_name="learner", out_dir=str(tmp_path))
    tel.health.event_window_s = 3.0
    system = SeedSystem(env_factory=CPU_CATCH, policy_step=policy, num_actors=2, unroll=8,
                        envs_per_actor=4, deadline_ms=1.0, algo="vtrace", max_param_lag=100,
                        train_step=vl.train_step, state=state, learner_batch=4,
                        policy_publish=policy.publish, transport="socket",
                        num_actor_hosts=2, num_gateways=2, telemetry=tel, ops_port=0,
                        supervise_hosts=True, host_stall_s=4.0,
                        wire_reconnect=BackoffPolicy(base_s=0.05, cap_s=0.5, max_retries=8,
                                                     seed=0))
    base = "http://%s:%d" % system.ops_address
    monkey = ChaosMonkey.scripted(ChaosEvent(0.5, "kill_actor_host", target=0),
                                  ChaosEvent(1.5, "sever_gateway_conn", target=1))
    verdicts, done = set(), threading.Event()

    def arm_and_poll():
        armed = False
        while not done.wait(0.2):
            try:
                rep = json.loads(_http_get(base + "/healthz")[1])
            except Exception:             # noqa: BLE001 — a missed poll is retried
                continue
            verdicts.add(rep["verdict"])
            if not armed and {"actor-host-0", "actor-host-1"} <= set(rep["components"]):
                monkey.start(system)
                armed = True

    poller = threading.Thread(target=arm_and_poll, daemon=True)
    poller.start()
    try:
        stats = system.run(seconds=6.0)
    finally:
        done.set()
        poller.join(timeout=5.0)
        monkey.stop()
        system.stop_ops()
    assert len(monkey.injected) == 2 and all(i[2] for i in monkey.injected), monkey.injected
    assert stats["host_errors"] == [] and stats["learner_steps"] > 0
    assert stats["host_cuda_initialized"] == [False] * len(system.pool.last_stats)
    rec = stats["recovery"]
    assert rec["host_faults"] >= 1 and rec["host_restarts"] >= 1, rec
    assert rec["reconnects"] >= 1, rec
    onp = stats["onpolicy"]
    assert onp["frames_generated"] == onp["frames_trained"] + onp["frames_dropped"] \
        + onp["frames_pending"]
    assert onp["frames_pending"] == 0
    assert system.server.num_slots <= system.num_actors * system.envs_per_actor
    assert "degraded" in verdicts, verdicts
    assert any("host_death" in b for b in tel.flightrec.bundles)
