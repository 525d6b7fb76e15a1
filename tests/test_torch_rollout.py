"""The port's device backend on the CPU, held to the JAX package: CartPole's
and TokenWorld's steps on injected states, a whole unroll of the engine
against the JAX package's `DeviceRolloutEngine` from the same carry, the
engine's own contract against a step-by-step loop over the same
generators, the rollout worker, and `SeedSystem(backend="device")` with
its launchers.

Mirrors ``tests/test_rollout.py`` and the device halves of
``tests/test_onpolicy.py``. Random draws come from torch generators, so
their values cannot equal JAX's: the deterministic parts are held exactly
or at a stated tolerance (CartPole's fp32 state within 1e-6: XLA and
PyTorch may round its products differently), the draws by their range.
System checks are on counts and ledgers, never on rates. The CUDA graph
is held to the same loop on the card by ``tests/test_torch_gpu.py`` and
``chip_smoke.py``'s phase 15.
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

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.envs.cartpole import CartPoleEnv as JCartPoleEnv, CartPoleState as JCartPoleState  # noqa: E402
from repro.envs.catch import CatchEnv as JCatchEnv  # noqa: E402
from repro.envs.tokenworld import TokenWorld as JTokenWorld, TokenWorldState as JTokenWorldState  # noqa: E402
from repro.onpolicy import mlp_actor_critic as jmlp_actor_critic  # noqa: E402
from repro.rollout import DeviceRolloutEngine as JDeviceRolloutEngine  # noqa: E402
from repro_torch.convert import mlp_params_from_jax  # noqa: E402
from repro_torch.core.system import SeedSystem  # noqa: E402
from repro_torch.envs.alesim import ALESimEnv  # noqa: E402
from repro_torch.envs.cartpole import CartPoleEnv, CartPoleState  # noqa: E402
from repro_torch.envs.catch import CatchEnv, CatchState  # noqa: E402
from repro_torch.envs.tokenworld import TokenWorld, TokenWorldState  # noqa: E402
from repro_torch.envs.vector import TorchVectorEnv, make_vector_env  # noqa: E402
from repro_torch.onpolicy import (VTraceLearner, make_device_sampling_policy,  # noqa: E402
                                  mlp_actor_critic)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.rollout import (DeviceRolloutEngine, RolloutWorker,  # noqa: E402
                                 ShardedRolloutEngine, action_generator, as_torch_env)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _catch():
    return CatchEnv(device="cpu")


def _random(num_actions):
    def policy_apply(params, core, obs, gen):
        return torch.randint(0, num_actions, (obs.shape[0],), generator=gen,
                             device=obs.device), core
    return policy_apply


def _host_loop(env, policy, lanes, steps, seed, params=None, with_logprobs=False):
    """Step-by-step loop following the engine's streams: the env's
    generator seeded `seed`, the action generator `action_generator(seed)`."""
    gen = torch.Generator(device=env.device).manual_seed(seed)
    act = action_generator(seed, env.device)
    state, obs = env.reset(lanes, gen)
    out = {k: [] for k in ("obs", "actions", "rewards", "dones")}
    if with_logprobs:
        out["behavior_logprobs"] = []
    core = None
    with torch.no_grad():
        for _ in range(steps):
            if with_logprobs:
                actions, lp, core = policy(params, core, obs, act)
                out["behavior_logprobs"].append(lp)
            else:
                actions, core = policy(params, core, obs, act)
            out["obs"].append(obs)
            out["actions"].append(actions.to(torch.int32))
            state, obs, reward, done = env.step(state, actions, gen)
            out["rewards"].append(reward)
            out["dones"].append(done)
    return {k: torch.stack(v).cpu().numpy() for k, v in out.items()}


def _assert_traj_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype, want[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------------ JAX parity

def _cartpole_states(rng):
    """(s (n,4), t (n,)): states away from every threshold, and states one
    step from crossing each (|x| > 2.4, |theta| > 12 degrees, t == 200) or
    staying just inside."""
    n = 64
    safe = np.stack([rng.uniform(-2.0, 2.0, n), rng.uniform(-1, 1, n),
                     rng.uniform(-0.15, 0.15, n), rng.uniform(-1, 1, n)], 1)
    edge = np.array([[2.39, 1.0, 0.0, 0.0], [-2.39, -1.0, 0.0, 0.0],
                     [2.35, 1.0, 0.0, 0.0], [0.0, 0.0, 0.205, 0.5],
                     [0.0, 0.0, -0.205, -0.5], [0.0, 0.0, 0.19, 0.3],
                     [0.5, 0.1, 0.05, 0.1], [0.5, 0.1, 0.05, 0.1]])
    s = np.concatenate([safe, edge]).astype(np.float32)
    t = np.concatenate([rng.integers(0, 198, n), [0, 5, 3, 7, 9, 2, 199, 198]])
    return s, t


def test_cartpole_step_matches_jax():
    """CartPole's step on injected states with both actions: reward and
    done equal on every lane, the state of every lane that goes on within
    1e-6 and its step count equal; a lane that ends restarts at t 0 from a
    draw in [-0.05, 0.05]."""
    s, t = _cartpole_states(np.random.default_rng(0))
    s, t = np.concatenate([s, s]), np.concatenate([t, t])
    act = np.repeat([0, 1], s.shape[0] // 2)
    n = s.shape[0]
    jst = JCartPoleState(jnp.asarray(s), jnp.asarray(t, jnp.int32),
                         jax.random.split(jax.random.PRNGKey(0), n))
    jnew, jobs, jrew, jdone = jax.vmap(JCartPoleEnv().step)(jst, jnp.asarray(act, jnp.int32))
    env = CartPoleEnv(device="cpu")
    st = CartPoleState(torch.from_numpy(s), torch.from_numpy(t.astype(np.int64)))
    new, obs, rew, done = env.step(st, torch.from_numpy(act.astype(np.int64)),
                                   torch.Generator().manual_seed(0))
    assert obs.shape == (n, 4) and obs.dtype == torch.float32 and done.dtype == torch.bool
    np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    d = done.numpy()
    assert d[-8:].tolist() == [True, True, False, True, True, False, True, False]
    np.testing.assert_allclose(obs.numpy()[~d], np.asarray(jobs)[~d], rtol=0, atol=1e-6)
    assert torch.equal(obs, new.s)
    np.testing.assert_array_equal(new.t.numpy(), np.asarray(jnew.t))
    assert (new.s[done].abs() <= 0.05).all()


def test_cartpole_reset_draws():
    env = CartPoleEnv(device="cpu")
    st, obs = env.reset(20000, torch.Generator().manual_seed(1))
    assert obs is st.s and obs.shape == (20000, 4) and (st.t == 0).all()
    assert (obs.abs() <= 0.05).all() and abs(float(obs.mean())) < 2e-3
    assert float(obs.std()) == pytest.approx(0.1 / np.sqrt(12), rel=0.03)


def test_tokenworld_step_matches_jax():
    """TokenWorld's step on injected states, half the actions on target:
    reward and done equal on every lane; position and obs (the next target
    token) equal on every lane that goes on; a lane that ends restarts at 0
    on a new pattern whose first token is its obs."""
    rng = np.random.default_rng(1)
    n, env = 256, TokenWorld(device="cpu")
    pos = np.concatenate([rng.integers(0, env.episode_len - 1, n - 8), [31] * 8])
    pattern = rng.integers(0, env.vocab_size, (n, env.period))
    target = pattern[np.arange(n), pos % env.period]
    act = np.where(rng.random(n) < 0.5, target, rng.integers(0, env.vocab_size, n))
    jenv = JTokenWorld()
    jst = JTokenWorldState(jnp.asarray(pos, jnp.int32), jnp.asarray(pattern, jnp.int32),
                           jax.random.split(jax.random.PRNGKey(0), n))
    jnew, jobs, jrew, jdone = jax.vmap(jenv.step)(jst, jnp.asarray(act, jnp.int32))
    st = TokenWorldState(torch.from_numpy(pos), torch.from_numpy(pattern))
    new, obs, rew, done = env.step(st, torch.from_numpy(act), torch.Generator().manual_seed(0))
    assert obs.shape == (n,) and obs.dtype == torch.int64 and rew.dtype == torch.float32
    np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    d = done.numpy()
    assert d.sum() == 8 and 0 < rew.sum() < n
    np.testing.assert_array_equal(obs.numpy()[~d], np.asarray(jobs)[~d])
    np.testing.assert_array_equal(new.pos.numpy(), np.asarray(jnew.pos))
    np.testing.assert_array_equal(new.pattern.numpy()[~d], pattern[~d])
    assert (obs[done] == new.pattern[done][:, 0]).all()
    assert (new.pattern >= 0).all() and (new.pattern < env.vocab_size).all()


def test_tokenworld_reset_and_vector_env():
    env = TokenWorld(device="cpu")
    st, obs = env.reset(64, torch.Generator().manual_seed(2))
    assert (st.pos == 0).all() and torch.equal(obs, st.pattern[:, 0])
    vec = make_vector_env(lambda: TokenWorld(device="cpu"), 4, seed=3)
    assert isinstance(vec, TorchVectorEnv) and vec.obs_shape == ()
    o = vec.reset()
    o2, r, d = vec.step(o)                   # echo the target: reward 1
    assert o2.dtype == np.int64 and o2.shape == (4,) and (r == 1.0).all() and not d.any()
    for factory in (lambda: CartPoleEnv(device="cpu"), CartPoleEnv(device="cpu")):
        vec = make_vector_env(factory, 3)
        assert isinstance(vec, TorchVectorEnv) and vec.reset().shape == (3, 4)


def test_engine_matches_the_jax_engine_on_catch():
    """From the JAX engine's initial carry, converted: T 8 (< rows - 1, so
    no lane ends and no draw is used) of a deterministic argmax policy on
    converted mlp_actor_critic params give the JAX engine's trajectory."""
    E, T = 6, 8
    jinit, japply = jmlp_actor_critic(50, 3)
    jp = {k: np.asarray(v) for k, v in jinit(jax.random.PRNGKey(4)).items()}
    jp["wp"] = (jp["wp"] * 100.0).astype(np.float32)
    tp = mlp_params_from_jax(jp)
    _, apply_fn = mlp_actor_critic(50, 3)
    jeng = JDeviceRolloutEngine(
        JCatchEnv(), lambda p, c, o, k: (jnp.argmax(japply(p, o)[0], -1), c), E, T, seed=5)
    jeng.reset()
    jst, _, jobs, _ = jeng._carry
    eng = DeviceRolloutEngine(_catch(), lambda p, c, o, g: (torch.argmax(apply_fn(p, o)[0], -1), c),
                              E, T, seed=5)
    eng.reset()
    eng._write_carry((CatchState(*(torch.from_numpy(np.asarray(x, np.int64))
                                   for x in (jst.ball_r, jst.ball_c, jst.paddle))),
                      None, torch.from_numpy(np.array(jobs))))
    want = jeng.rollout(jp)
    got = eng.rollout(tp)
    assert not want["dones"].any() and len(np.unique(want["actions"])) > 1
    _assert_traj_equal(got, {k: np.asarray(v) for k, v in want.items()})


# --------------------------------------------------- the engine's contract

@pytest.mark.parametrize("env_cls", [CartPoleEnv, CatchEnv, TokenWorld])
def test_unroll_matches_host_loop(env_cls):
    """The engine's unroll is step-for-step the host loop over the same two
    generators, across auto-reset boundaries."""
    env = env_cls(device="cpu")
    E, T, seed = 4, 50, 11
    policy = _random(env.num_actions)
    traj = DeviceRolloutEngine(env, policy, E, T, seed=seed).rollout(None)
    ref = _host_loop(env, policy, E, T, seed)
    assert ref["dones"].any()
    _assert_traj_equal(traj, ref)


def test_unroll_resumes_across_calls():
    """Two unrolls of T equal one host loop of 2T: the carry persists."""
    E, T, seed = 3, 20, 5
    policy = _random(3)
    eng = DeviceRolloutEngine(_catch(), policy, E, T, seed=seed)
    t1, t2 = eng.rollout(None), eng.rollout(None)
    ref = _host_loop(_catch(), policy, E, 2 * T, seed)
    _assert_traj_equal({k: np.concatenate([t1[k], t2[k]]) for k in t1}, ref)


def test_warmup_does_not_advance():
    """After warmup (which runs the unroll once, as capture does on the
    card), the first rollout is the host loop's from the seed, behavior
    logprobs included; the counters start at the first rollout."""
    _, apply_fn = mlp_actor_critic(50, 3)
    params = mlp_actor_critic(50, 3)[0](torch.Generator().manual_seed(0), "cpu")
    policy = make_device_sampling_policy(apply_fn)
    eng = DeviceRolloutEngine(_catch(), policy, 4, 12, seed=9, with_logprobs=True)
    eng.warmup(params)
    assert eng.scans == 0 and eng.frames == 0 and eng.captures == 0
    traj = eng.rollout(params)
    ref = _host_loop(_catch(), policy, 4, 12, 9, params, with_logprobs=True)
    _assert_traj_equal(traj, ref)
    assert eng.scans == 1 and eng.frames == 48


def test_engine_with_recurrent_core_state():
    """Core state threads through the unroll and across unrolls."""
    E, T = 2, 7

    def policy_apply(params, core, obs, gen):
        return torch.zeros((obs.shape[0],), dtype=torch.int64), core + 1

    eng = DeviceRolloutEngine(_catch(), policy_apply, E, T,
                              init_core=lambda e: torch.zeros((e,), dtype=torch.int32))
    eng.rollout(None)
    assert eng._carry[1].tolist() == [T] * E
    eng.rollout(None)
    assert eng._carry[1].tolist() == [2 * T] * E


def test_engine_rejects_host_env():
    with pytest.raises(ValueError, match="batched torch env"):
        DeviceRolloutEngine(ALESimEnv(frame=8, step_cost=16), _random(18), 2, 4)
    with pytest.raises(ValueError, match="ALESimEnv, a host env"):
        as_torch_env(lambda: ALESimEnv(frame=8, step_cost=16))


def test_engine_frame_accounting():
    E, T = 4, 12
    eng = DeviceRolloutEngine(_catch, _random(3), E, T)
    for _ in range(3):
        eng.rollout(None)
    assert eng.scans == 3 and eng.frames == 3 * T * E and eng.captures == 0


def test_action_stream_is_its_own():
    """The action generator's stream is not the env's from the same seed,
    nor from a nearby one (the CPU generator keeps 32 bits of a seed)."""
    a = torch.randint(0, 1000, (64,), generator=action_generator(7, "cpu"))
    for s in range(16):
        b = torch.randint(0, 1000, (64,), generator=torch.Generator().manual_seed(s))
        assert not torch.equal(a, b)


def test_sharded_lanes_split_and_seeded():
    """Lanes split contiguously (5 over 2: 3 and 2), shard k seeded
    seed * K + k, all K dispatched before any copy back: the sharded
    trajectory is the two single engines' side by side."""
    E, T, K, seed = 5, 6, 2, 3
    policy = _random(3)
    sh = ShardedRolloutEngine(_catch, policy, E, T, num_shards=K, seed=seed)
    assert [e.num_envs for e in sh.engines] == [3, 2]
    assert [e._seed for e in sh.engines] == [6, 7] and sh.devices == [torch.device("cpu")] * 2
    got = sh.rollout(None)
    parts = [DeviceRolloutEngine(_catch(), policy, n, T, seed=s).rollout(None)
             for n, s in ((3, 6), (2, 7))]
    _assert_traj_equal(got, {k: np.concatenate([p[k] for p in parts], axis=1) for k in got})
    assert sh.scans == 1 and sh.shard_scans == K and sh.frames == T * E
    for bad in (0, -1, "2"):
        with pytest.raises(ValueError, match="positive int"):
            ShardedRolloutEngine(_catch, policy, E, T, num_shards=bad)
    with pytest.raises(ValueError, match="exceeds num_envs"):
        ShardedRolloutEngine(_catch, policy, 2, T, num_shards=3)
    with pytest.raises(ValueError, match="no devices"):
        ShardedRolloutEngine(_catch, policy, E, T, num_shards=2, devices=[])


# ------------------------------------------------------ worker and system

def _wait(cond, timeout=20.0):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.01)


def test_worker_feeds_per_lane_unrolls_and_counts():
    E, T = 3, 6
    eng = DeviceRolloutEngine(_catch, _random(3), E, T, seed=2)
    sunk = []
    w = RolloutWorker(0, eng, sunk.append, lambda: (None, 0))
    w.start()
    _wait(lambda: w.iterations >= 2)
    w.stop()
    w.join()
    assert not w._thread.is_alive()
    assert w.error is None, w.error
    assert w.iterations >= 2 and w.frames == w.iterations * T * E
    assert len(sunk) == w.iterations * E        # one unroll per lane per unroll
    traj = sunk[0]
    assert traj["obs"].shape == (T, 50)
    assert traj["actions"].dtype == np.int32 and traj["rewards"].dtype == np.float32
    assert traj["dones"].dtype == np.float32
    # Catch episodes are rows-1 steps long, so the unrolls crossed boundaries
    assert w.episodes > 0 and len(w.returns) == w.episodes


def test_worker_error_is_surfaced():
    def bad_policy(params, core, obs, gen):
        raise TypeError("policy-fault")

    w = RolloutWorker(0, DeviceRolloutEngine(_catch, bad_policy, 2, 4), lambda t: None,
                      lambda: (None, 0))
    w.start()
    w.join(timeout=10.0)
    assert not w._thread.is_alive()
    assert w.error is not None and "policy-fault" in w.error


def test_seed_system_device_frame_accounting():
    E, T, N = 4, 8, 2
    sys_ = SeedSystem(env_factory=_catch, backend="device", policy_apply=_random(3),
                      num_actors=N, unroll=T, envs_per_actor=E)
    assert sys_.server is None
    sys_.warmup()
    stats = sys_.run(seconds=0.6, with_learner=False)
    assert stats["backend"] == "device" and stats["inference_error"] is None
    assert stats["env_frames"] == stats["scans"] * T * E > 0
    assert stats["inference_batches"] == 0 and stats["engine_shards"] == 1
    for a in sys_.actors:
        assert a.frames == a.iterations * T * E
    assert len(sys_.replay) > 0
    traj, _, _ = sys_.replay.sample(1)
    assert traj["obs"].shape[1] == T


def test_seed_system_device_engine_shards():
    sys_ = SeedSystem(env_factory=_catch, backend="device", policy_apply=_random(3),
                      num_actors=2, unroll=4, envs_per_actor=5, engine_shards=2)
    assert all(isinstance(a.engine, ShardedRolloutEngine) for a in sys_.actors)
    assert [[e._seed for e in a.engine.engines] for a in sys_.actors] == [[0, 1], [2, 3]]
    sys_.warmup()
    stats = sys_.run(seconds=0.5, with_learner=False)
    assert stats["engine_shards"] == 2 and stats["inference_error"] is None
    assert stats["env_frames"] == stats["scans"] * 4 * 5 > 0


def _inplace_train_step(state, batch):
    """Updates the params in place, as the port's train steps do."""
    with torch.no_grad():
        for v in state["params"].values():
            v.add_(1.0)
    return {"params": state["params"], "step": state["step"] + 1}, {"loss": torch.zeros(())}


def test_seed_system_device_with_learner_and_param_lag():
    """The learner publishes versioned params; workers refresh between
    unrolls and track the on-policy lag."""
    sys_ = SeedSystem(env_factory=_catch, backend="device", policy_apply=_random(3),
                      num_actors=1, unroll=8, envs_per_actor=4,
                      train_step=_inplace_train_step,
                      state={"params": {"w": torch.zeros(())}, "step": 0},
                      learner_batch=2, min_replay=2)
    sys_.warmup()
    stats = sys_.run(seconds=1.0)
    assert stats["learner_error"] is None, stats["learner_error"]
    assert stats["learner_steps"] > 0
    assert stats["param_refreshes"] > 0 and stats["mean_param_lag"] > 0
    for a in sys_.actors:
        assert a.param_lag_total == a.param_version
    params, version = sys_._param_source()
    assert version == stats["learner_steps"] and float(params["w"]) == version


def test_published_snapshot_is_never_mutated():
    """A publisher updates the learner's params in place and publishes
    them, as the learner thread does, while readers take (params, version)
    from the seam: every snapshot holds its version's values, then and
    after later updates."""
    live = {"w": torch.zeros(256), "b": torch.zeros(3)}
    sys_ = SeedSystem(env_factory=_catch, backend="device", policy_apply=_random(3),
                      num_actors=1, unroll=4, envs_per_actor=2, train_step=_inplace_train_step,
                      state={"params": live, "step": 0})
    first, _ = sys_._param_source()
    assert first["w"].data_ptr() != live["w"].data_ptr()
    stop = threading.Event()
    torn, kept = [], []

    def publisher():
        v = 0
        while not stop.is_set():
            _inplace_train_step({"params": live, "step": v}, None)
            v += 1
            sys_._publish(live, v)

    def reader():
        while not stop.is_set():
            params, version = sys_._param_source()
            if not all(bool((x == version).all()) for x in params.values()):
                torn.append(version)
            if len(kept) < 200:
                kept.append((params, version))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=publisher)] + [
        threading.Thread(target=reader) for _ in range(3)]
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
    assert kept and not torn, torn[:5]
    assert float(live["w"][0]) > kept[-1][1]
    assert all(bool((x == v).all()) for p, v in kept for x in p.values())
    assert all(bool((x == 0).all()) for x in first.values())


def _vtrace_device_system(**kw):
    init_fn, apply_fn = mlp_actor_critic(50, 3)
    vl = VTraceLearner(apply_fn, adamw(1e-3))
    state = vl.init_state(init_fn(torch.Generator().manual_seed(0), "cpu"))
    return SeedSystem(env_factory=_catch, backend="device", policy_apply=vl.device_policy_apply(),
                      num_actors=2, unroll=8, envs_per_actor=4, algo="vtrace",
                      train_step=vl.train_step, state=state, learner_batch=4, **kw)


def _assert_trained_and_conserved(stats):
    assert stats["learner_error"] is None, stats["learner_error"]
    assert stats["inference_error"] is None, stats["inference_error"]
    assert stats["learner_steps"] > 0, stats
    onp = stats["onpolicy"]
    assert onp["frames_pending"] == 0 and onp["frames_trained"] > 0, onp
    assert onp["frames_generated"] == onp["frames_trained"] + onp["frames_dropped"], onp


@pytest.mark.parametrize("shards", [1, 2])
def test_vtrace_trains_device_backend(shards):
    sys_ = _vtrace_device_system(queue_capacity=32, max_param_lag=10, engine_shards=shards)
    sys_.warmup()
    stats = sys_.run(seconds=1.5)
    assert stats["engine_shards"] == shards
    _assert_trained_and_conserved(stats)
    onp = stats["onpolicy"]
    # every generated frame came from an unroll of 8 steps x 4 lanes
    assert onp["frames_generated"] == stats["scans"] * 8 * 4
    assert onp["capacity"] == 32 and onp["max_param_lag"] == 10
    for a in sys_.actors:
        assert a.param_lag_total == a.param_version


def test_resume_works_without_a_server(tmp_path):
    sys_ = _vtrace_device_system(checkpoint_dir=str(tmp_path), checkpoint_every=1)
    first = sys_.run(seconds=1.0)
    _assert_trained_and_conserved(first)
    sys_.learner.ckpt.wait()
    live = sys_.learner.state["params"]
    version = sys_.resume()
    assert version == sys_.learner.steps
    params, v = sys_._param_source()
    assert v == version and params["w1"].data_ptr() != live["w1"].data_ptr()
    assert all(not a._stop.is_set() and a.error is None for a in sys_.actors)
    second = sys_.run(seconds=1.0)
    _assert_trained_and_conserved(second)
    assert second["scans"] > first["scans"]
    assert second["recovery"]["checkpoint_restores"] == 1


# ---------------------------------------------------------------- launchers

def _cli(module, *args):
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, "-m", f"repro_torch.launch.{module}", *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=240, env=env)


def test_rollout_backends_cli_prints_its_rows():
    res = _cli("rollout_backends", "--device", "cpu", "--seconds", "0.3")
    assert res.returncode == 0, res.stderr[-2000:]
    rows = [line.split(",")[0] for line in res.stdout.splitlines()
            if line.startswith("fig3")]
    assert rows == ["fig3d_per_step_host", "fig3d_vectorized_host", "fig3d_device_resident",
                    "fig3e_engine_shards_1", "fig3e_engine_shards_2"]
    assert res.stdout.splitlines()[-1].startswith("device_resident >= vectorized_host: ")


def test_train_vtrace_cli_device_backend_prints_its_rows():
    res = _cli("train_vtrace", "--backend", "device", "--device", "cpu", "--actors", "1",
               "--seconds", "1.0")
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.splitlines()
    assert "device backend" in lines[0] and "max_param_lag 10" in lines[0]
    assert [line.split(",")[0] for line in lines if line.startswith("fig3f")] == [
        "fig3f_vtrace_actors_1"]
    assert lines[-1].startswith("ok — frame ledger conserved")


@pytest.mark.parametrize("module, args", [("rollout_backends", ()),
                                          ("train_vtrace", ("--backend", "device"))])
def test_launchers_without_device_raise_where_there_is_no_card(module, args):
    res = _cli(module, *args, "--seconds", "0.3")
    assert res.returncode != 0
    assert "torch.cuda.is_available() is False" in res.stderr
    assert "fig3" not in res.stdout
