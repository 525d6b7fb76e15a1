"""The port's SEED system on the CPU: prioritized replay (against the JAX
package's, which is numpy only), the host vector env, SeedSystem's frame
accounting and surfaced errors, its refused branches, and a short R2D2
run with the learner through ``repro_torch.launch.train_r2d2``.

Mirrors ``tests/test_rl_core.py``'s replay tests,
``tests/test_vector_env.py``'s SyncVectorEnv and SeedSystem tests and
``tests/test_system.py``'s frame count. Every check is on counts, never
on rates: the tests share the machine with other test processes.
"""

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core.replay import PrioritizedReplay as JPrioritizedReplay  # noqa: E402
from repro_torch.configs.r2d2_atari import AtariConfig  # noqa: E402
from repro_torch.core.replay import PrioritizedReplay  # noqa: E402
from repro_torch.core.system import SeedSystem  # noqa: E402
from repro_torch.envs.alesim import ALESimEnv  # noqa: E402
from repro_torch.envs.catch import CatchEnv  # noqa: E402
from repro_torch.envs.vector import (SyncVectorEnv, TorchVectorEnv, VectorEnv,  # noqa: E402
                                     make_vector_env)
from repro_torch.launch import train_r2d2  # noqa: E402
from repro_torch.telemetry import Telemetry  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# the example's reduced config (examples/train_atari_r2d2.py)
REDUCED = AtariConfig(obs_size=42, obs_channels=2, core_dim=128, num_actions=6, burn_in=4,
                      unroll=16, n_step=3, target_update_period=50)


# ------------------------------- replay -------------------------------------

def test_replay_ring_overwrite_and_sampling():
    buf = PrioritizedReplay(capacity=8, alpha=1.0, seed=0)
    for i in range(12):
        buf.add({"x": np.full((3,), i, np.float32)}, priority=1.0)
    assert len(buf) == 8
    batch, idx, w = buf.sample(16, beta=0.5)
    assert batch["x"].shape == (16, 3)
    assert batch["x"].min() >= 4  # first 4 were overwritten
    assert w.shape == (16,) and w.max() <= 1.0 + 1e-6


@settings(deadline=None, max_examples=10)
@given(st.lists(st.floats(0.01, 100.0), min_size=2, max_size=16))
def test_replay_priority_proportionality(priorities):
    buf = PrioritizedReplay(capacity=32, alpha=1.0, seed=1)
    for i, p in enumerate(priorities):
        buf.add({"x": np.float32([i])}, priority=p)
    _, idx, _ = buf.sample(4000, beta=0.0)
    counts = np.bincount(idx, minlength=len(priorities)).astype(float)
    emp = counts / counts.sum()
    expect = np.array(priorities) / np.sum(priorities)
    # loose statistical check on the high-priority items
    top = int(np.argmax(expect))
    assert abs(emp[top] - expect[top]) < 0.12


def test_replay_update_priorities():
    buf = PrioritizedReplay(capacity=4, alpha=1.0, seed=2)
    for i in range(4):
        buf.add({"x": np.float32([i])}, priority=0.001)
    buf.update_priorities(np.array([2]), np.array([1000.0]))
    _, idx, _ = buf.sample(100)
    assert (idx == 2).mean() > 0.9


@pytest.mark.parametrize("seed", [0, 7])
def test_replay_samples_as_the_reference_does(seed):
    """The same seed, adds, priority updates and samples give the same
    indices, weights and records as the JAX package's buffer."""
    rng = np.random.default_rng(seed)
    bufs = [cls(capacity=24, alpha=0.9, seed=seed)
            for cls in (PrioritizedReplay, JPrioritizedReplay)]
    for i in range(40):                         # wraps the ring
        seq = {"obs": rng.integers(0, 256, (5, 3, 3, 2), dtype=np.uint8),
               "rewards": rng.standard_normal(5).astype(np.float32)}
        pri = float(rng.uniform(0.1, 3.0))
        for buf in bufs:
            buf.add(seq, pri)
        if i % 7 == 6:
            outs = [buf.sample(6, beta=0.6) for buf in bufs]
            (b0, i0, w0), (b1, i1, w1) = outs
            np.testing.assert_array_equal(i0, i1)
            np.testing.assert_array_equal(w0, w1)
            for k in b1:
                np.testing.assert_array_equal(b0[k], b1[k])
            new = rng.uniform(0.0, 5.0, 6)
            for buf, idx in zip(bufs, (i0, i1)):
                buf.update_priorities(idx, new)
    np.testing.assert_array_equal(bufs[0]._priorities, bufs[1]._priorities)


# ----------------------------- SyncVectorEnv ---------------------------------

class _CountdownEnv:
    """Episode of fixed length; obs is the step count; no auto-reset."""
    num_actions = 2
    obs_shape = (1,)

    def __init__(self, length):
        self.length = length
        self.t = 0

    def reset(self):
        self.t = 0
        return np.zeros((1,), np.float32)

    def step(self, action):
        self.t += 1
        done = self.t >= self.length
        return np.array([float(self.t)], np.float32), 1.0, done


def test_sync_vector_env_per_lane_auto_reset():
    """Lanes with different episode lengths reset independently; a done
    lane's next obs is the fresh episode's reset obs."""
    lengths = [2, 3, 5]
    vec = SyncVectorEnv(None, envs=[_CountdownEnv(n) for n in lengths])
    obs = vec.reset()
    np.testing.assert_array_equal(obs, np.zeros((3, 1)))
    seen_dones = np.zeros(3, int)
    for t in range(1, 31):
        obs, rew, done = vec.step(np.zeros(3, int))
        for lane, n in enumerate(lengths):
            expect_done = (t % n) == 0
            assert bool(done[lane]) == expect_done, (t, lane)
            expected = 0.0 if expect_done else float(t % n)
            assert obs[lane, 0] == expected, (t, lane, obs[lane, 0])
            seen_dones[lane] += int(done[lane])
    assert (seen_dones > 2).all()


def test_sync_vector_env_respects_env_auto_reset():
    """ALESim auto-resets internally; the wrapper must not reset it again."""
    vec = SyncVectorEnv(lambda: ALESimEnv(frame=8, step_cost=16, episode_len=3), 2)
    vec.reset()
    dones = 0
    for _ in range(7):
        _, _, d = vec.step(np.zeros(2, int))
        dones += int(d.sum())
    assert dones == 4  # 2 lanes x 2 episode boundaries in 7 steps


def test_sync_vector_env_lanes_decorrelated():
    """Host lanes built from ONE factory must not be clones, and the same
    seed gives the same lane states."""
    vec = make_vector_env(lambda: ALESimEnv(frame=8, step_cost=16), 4, seed=1)
    obs = vec.reset()
    assert not any(np.array_equal(obs[0], obs[i]) for i in range(1, 4))
    vec2 = make_vector_env(lambda: ALESimEnv(frame=8, step_cost=16), 4, seed=1)
    np.testing.assert_array_equal(obs, vec2.reset())


class _KeyedEnv:
    """A pure-JAX-style env: reset takes a key."""
    num_actions = 3

    def reset(self, key):
        return None, np.zeros(2)


def test_make_vector_env_dispatch():
    host = make_vector_env(lambda: ALESimEnv(frame=8, step_cost=16), 3)
    assert isinstance(host, SyncVectorEnv) and host.num_envs == 3
    assert isinstance(host, VectorEnv)
    assert make_vector_env(host, 3) is host   # VectorEnv passes through
    for env in (_KeyedEnv, _KeyedEnv()):
        with pytest.raises(NotImplementedError, match="device backend"):
            make_vector_env(env, 4)
    # a batched torch env goes to TorchVectorEnv, factory or instance
    for env in (lambda: CatchEnv(device="cpu"), CatchEnv(device="cpu")):
        vec = make_vector_env(env, 4)
        assert isinstance(vec, TorchVectorEnv) and vec.num_envs == 4


def test_make_vector_env_rejects_prebuilt_host_env_multi_lane():
    env = ALESimEnv(frame=8, step_cost=16)
    with pytest.raises(ValueError, match="pre-built env"):
        make_vector_env(env, 4)
    assert make_vector_env(env, 1).num_envs == 1


# ------------------------------ SeedSystem ------------------------------------

def _random_policy(n_actions):
    rng = np.random.default_rng(0)
    lock = threading.Lock()

    def policy_step(obs, ids):
        with lock:
            return rng.integers(0, n_actions, size=(obs.shape[0],))
    return policy_step


def _ale(**kw):
    return lambda: ALESimEnv(**{"frame": 16, "step_cost": 64, "episode_len": 50, **kw})


def test_seed_system_runs_and_counts_frames():
    def policy_step(obs, ids):
        return np.zeros((obs.shape[0],), np.int32)

    sys_ = SeedSystem(env_factory=_ale(), policy_step=policy_step, num_actors=3, unroll=10,
                      deadline_ms=2.0)
    stats = sys_.run(seconds=1.0, with_learner=False)
    assert stats["env_frames"] > 50, stats
    assert stats["inference_batches"] > 0
    assert 0 < stats["mean_batch_occupancy"] <= 1.0


def test_seed_system_frame_accounting_with_lanes():
    E = 4
    sys_ = SeedSystem(env_factory=_ale(), policy_step=_random_policy(18), num_actors=2,
                      unroll=10, envs_per_actor=E, deadline_ms=2.0)
    stats = sys_.run(seconds=1.0, with_learner=False)
    assert stats["envs_per_actor"] == E
    assert stats["env_frames"] == stats["actor_iterations"] * E
    for a in sys_.actors:
        assert a.frames == a.iterations * E
    assert stats["env_frames"] > 50, stats
    assert stats["inference_lanes"] >= stats["env_frames"]
    if len(sys_.replay):
        traj, _, _ = sys_.replay.sample(1)
        assert traj["obs"].shape[1] == 10


def test_inference_error_is_surfaced():
    def bad_policy(obs, ids):
        raise IndexError("slot-overflow")

    sys_ = SeedSystem(env_factory=_ale(step_cost=32), policy_step=bad_policy, num_actors=1,
                      unroll=4, deadline_ms=2.0)
    stats = sys_.run(seconds=0.5, with_learner=False)
    assert stats["inference_error"] is not None
    assert "slot-overflow" in stats["inference_error"]
    assert stats["env_frames"] == 0


def test_learner_error_is_surfaced():
    def bad_train_step(state, batch):
        raise RuntimeError("boom")

    sys_ = SeedSystem(env_factory=_ale(step_cost=32), policy_step=_random_policy(18),
                      num_actors=1, unroll=4, train_step=bad_train_step, state={},
                      learner_batch=1, min_replay=1, deadline_ms=2.0)
    stats = sys_.run(seconds=1.0)
    assert stats["learner_error"] is not None
    assert "boom" in stats["learner_error"]


def test_throughput_keeps_the_reference_keys():
    sys_ = SeedSystem(env_factory=_ale(), policy_step=_random_policy(18), num_actors=2,
                      unroll=4, envs_per_actor=2, num_replicas=2, deadline_ms=2.0)
    stats = sys_.run(seconds=0.3, with_learner=False)
    keys = {"elapsed_s", "backend", "transport", "algo", "envs_per_actor",
            "actor_iterations", "env_frames", "env_frames_per_s", "learner_steps",
            "learner_steps_per_s", "learner_error", "episode_return_mean",
            "unroll_flushes", "mean_param_lag", "onpolicy", "recovery",
            "inference_batches", "inference_lanes", "inference_rpcs",
            "batch_occupancy_sum", "queue_wait_s_sum", "inference_compute_s",
            "inference_error", "num_replicas", "mean_batch_occupancy",
            "mean_queue_wait_ms", "replica_lanes", "replica_occupancy"}
    assert keys <= set(stats), keys - set(stats)
    assert stats["num_replicas"] == 2 and sum(stats["replica_lanes"]) == stats["inference_lanes"]
    assert (stats["backend"], stats["transport"], stats["algo"]) == ("host", "inproc", "r2d2")


def test_checkpoint_dir_saves_and_resume_restores(tmp_path):
    """checkpoint_dir builds the port's CheckpointManager; the learner saves
    every step; resume() restores the latest save into the live params and
    re-publishes them at a version that never goes back."""
    params = torch.nn.Linear(2, 2)
    with torch.no_grad():
        params.weight.zero_()          # so that k steps of +1 leave exactly k
    published = []

    def train_step(state, batch):
        with torch.no_grad():
            state["params"].weight.add_(1.0)
        return {"params": state["params"], "step": state["step"] + 1}, {"loss": torch.zeros(())}

    sys_ = SeedSystem(env_factory=_ale(), policy_step=_random_policy(18), num_actors=1,
                      unroll=4, train_step=train_step, state={"params": params, "step": 0},
                      learner_batch=1, min_replay=1, checkpoint_dir=str(tmp_path),
                      checkpoint_every=1, deadline_ms=2.0,
                      policy_publish=lambda p, v: published.append(v))
    stats = sys_.run(seconds=1.0)
    assert stats["learner_error"] is None and stats["learner_steps"] > 0
    sys_.learner.ckpt.wait()
    saved = sys_.learner.ckpt.latest_step()
    assert saved == stats["learner_steps"] and sys_.learner.ckpt.saves == saved
    with torch.no_grad():
        params.weight.fill_(-1.0)                 # the crash loses the live params
    version = sys_.resume()
    assert version == saved and published[-1] == version
    assert torch.equal(params.weight.detach(), torch.full((2, 2), float(saved)))
    assert sys_.throughput(1.0)["recovery"]["checkpoint_restores"] == 1


@pytest.mark.parametrize("kw", [
    {"telemetry": object()}, {"ops_port": 0}, {"autoscale": object()},
    {"transport": "socket", "telemetry": object()},
    {"transport": "shm", "autoscale": object()}])
def test_unported_branches_raise(kw):
    """The ops branches as the reference takes them (they were refused
    before their port): a `telemetry` that is not a `Telemetry`, or an
    `autoscale` that is not an `AutoscaleConfig`, raises TypeError before
    anything is built, on every transport; ``ops_port=0`` alone builds the
    default bundle and binds an ephemeral port until `stop_ops`."""
    def make():
        return SeedSystem(env_factory=_ale(), policy_step=_random_policy(18), num_actors=1,
                          unroll=4, **kw)
    if "ops_port" in kw:
        system = make()
        try:
            assert isinstance(system.telemetry, Telemetry)
            host, port = system.ops_address
            assert host == "127.0.0.1" and port > 0
        finally:
            system.stop_ops()
        assert system.ops_address is None
        return
    name = "telemetry" if "telemetry" in kw else "autoscale"
    with pytest.raises(TypeError, match=f"{name} must be a repro_torch"):
        make()


@pytest.mark.parametrize("kw, match", [
    ({"backend": "tpu"}, "unknown backend"), ({"algo": "ppo"}, "unknown algo"),
    ({"gamma": 0.9}, "applies to algo='vtrace'"),
    ({"transport": "udp"}, "unknown transport"),
    ({"num_gateways": 2}, "applies to wire transports"),
    ({"engine_shards": 2}, "applies to backend='device'"),
    ({"wire_quant": "f16"}, "applies to wire transports"),
    ({"supervise_hosts": True}, "apply to wire transports"),
    ({"checkpoint_every_s": 1.0}, "needs somewhere to save"),
    ({"backend": "device"}, "^backend='device' requires policy_apply$")])
def test_validation_messages_as_the_reference(kw, match):
    with pytest.raises(ValueError, match=match):
        SeedSystem(env_factory=_ale(), policy_step=_random_policy(18), num_actors=1,
                   unroll=4, **kw)


# ------------------------- R2D2 through train_r2d2 ---------------------------

def test_published_params_give_one_version_per_batch():
    """A reader that holds the seam's lock, as policy_step does, sees one
    version of every parameter while a publisher overwrites them leaf by
    leaf; policy_step waits on that lock."""
    run = train_r2d2.build(REDUCED, actors=1, envs_per_actor=2, device="cpu")
    pub = run.published
    src = [type(pub.params)(REDUCED, seed=0, device="cpu") for _ in range(2)]
    with torch.no_grad():
        for v, module in enumerate(src):
            for p in module.parameters():
                p.fill_(float(v))
    stop = threading.Event()
    torn = []

    def publisher():
        v = 0
        while not stop.is_set():
            pub.publish(src[v % 2], v)
            v += 1

    def reader():
        while not stop.is_set():
            with pub.lock:
                seen = set()
                for p in pub.params.parameters():
                    seen.add(float(p.view(-1)[0]))
                    time.sleep(0)
            if len(seen) != 1:
                torn.append(seen)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    threads = [threading.Thread(target=publisher)] + [
        threading.Thread(target=reader) for _ in range(2)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.5)
    finally:
        stop.set()
        sys.setswitchinterval(old)
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not torn, torn[:3]

    obs = np.zeros((2, 42, 42, 2), np.uint8)
    done = threading.Event()
    with pub.lock:
        t = threading.Thread(target=lambda: (run.policy_step(obs, np.arange(2)), done.set()))
        t.start()
        assert not done.wait(0.3), "policy_step ran its forward without the seam's lock"
    t.join(timeout=10)
    assert done.is_set()


def test_r2d2_system_trains_and_publishes():
    """A short SEED R2D2 run at the example's reduced config: the learner
    steps, every step updates the sampled priorities, and the inference copy
    of the params is its own storage, equal to the last publish."""
    run = train_r2d2.build(REDUCED, actors=2, envs_per_actor=2, device="cpu")
    system = run.system
    updates = []
    update = system.replay.update_priorities

    def counting(idx, pri):
        updates.append(len(idx))
        update(idx, pri)
    system.replay.update_priorities = counting
    stats = system.run(seconds=2.5)
    assert stats["learner_error"] is None and stats["inference_error"] is None
    assert stats["env_frames"] == stats["actor_iterations"] * 2
    assert stats["learner_steps"] > 0
    assert len(updates) == stats["learner_steps"] and set(updates) == {2}
    state = system.learner.state
    assert state["step"] == stats["learner_steps"] + 1      # the warm-up step first
    assert run.published.version == stats["learner_steps"]
    for (name, p), q in zip(state["params"].named_parameters(),
                            run.published.params.parameters()):
        assert p.data_ptr() != q.data_ptr(), name
        assert torch.equal(p.detach(), q), name
    assert all(t.device.type == "cpu" for t in run.core.values())


def _cli(*args, env_extra=None):
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": "", **(env_extra or {})}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train_r2d2", *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=240, env=env)


def test_cli_runs_on_the_cpu_and_prints_ok():
    res = _cli("--device", "cpu", "--actors", "2", "--envs-per-actor", "2",
               "--seconds", "2")
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.splitlines()
    assert lines[-1].startswith("ok — actors, central inference, replay and learner")
    assert any(line.split()[:1] == ["learner_steps"] for line in lines)


def test_cli_without_device_raises_where_there_is_no_card():
    res = _cli("--seconds", "1")
    assert res.returncode != 0
    assert "torch.cuda.is_available() is False" in res.stderr
    assert "ok" not in res.stdout
