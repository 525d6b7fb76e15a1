"""The port's on-policy half on the CPU, held to the JAX package: the
trajectory queue and batcher (numpy, against the reference's copies on the
same operations), the MLP actor-critic and the V-trace train step on
converted params, the sampling policy's logprobs and draws, Catch's
dynamics on injected states, a threadless learning anchor on Catch, and
`SeedSystem(algo="vtrace")` with its launcher.

Mirrors ``tests/test_onpolicy.py``. Random draws come from torch
generators, so their values cannot equal JAX's: the deterministic parts
are held exactly or at a stated tolerance, the draws by their range and
distribution. System checks are on counts, never on rates.
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

from repro.core.system import SeedSystem as JSeedSystem  # noqa: E402
from repro.envs.catch import CatchEnv as JCatchEnv, CatchState as JCatchState  # noqa: E402
from repro.onpolicy import (Closed as JClosed, TrajectoryQueue as JTrajectoryQueue,  # noqa: E402
                            assemble_vtrace_batch as jassemble,
                            make_device_sampling_policy as jmake_device_sampling_policy,
                            make_vtrace_train_step as jmake_vtrace_train_step,
                            mlp_actor_critic as jmlp_actor_critic)
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.convert import mlp_params_from_jax  # noqa: E402
from repro_torch.core.actor import flush_lane_unrolls  # noqa: E402
from repro_torch.core.learner import BatchSourceClosed, Learner  # noqa: E402
from repro_torch.core.system import ZERO_LEDGER, SeedSystem  # noqa: E402
from repro_torch.envs.catch import CatchEnv, CatchState  # noqa: E402
from repro_torch.envs.vector import TorchVectorEnv, make_vector_env  # noqa: E402
from repro_torch.launch import train_vtrace  # noqa: E402
from repro_torch.onpolicy import (Closed, SamplingPolicy, TrajectoryQueue,  # noqa: E402
                                  VTraceBatcher, VTraceLearner, assemble_vtrace_batch,
                                  make_device_sampling_policy, make_vtrace_train_step,
                                  mlp_actor_critic)
from repro_torch.optim import adamw  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
OBS_DIM = 50          # CatchEnv() default 10x5


def _unroll(t=4, version=None, value=1.0):
    u = {"obs": np.full((t, 3), value, np.float32),
         "actions": np.zeros((t,), np.int32),
         "rewards": np.ones((t,), np.float32),
         "dones": np.zeros((t,), np.float32),
         "behavior_logprobs": np.full((t,), -0.5, np.float32)}
    if version is not None:
        u["param_version"] = np.int64(version)
    return u


def _ledger_conserved(s):
    return s["frames_generated"] == (s["frames_trained"] + s["frames_dropped"]
                                     + s["frames_pending"])


def _catch():
    return CatchEnv(device="cpu")


def _close(got, want, tol):
    """|got - want| <= tol * max |want|, same shape."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{err:.3e} > {tol:g} * {scale:.3e}"


# --------------------------------------------------------- TrajectoryQueue

def test_queue_admission_and_conservation():
    version = {"v": 0}
    q = TrajectoryQueue(capacity=4, max_param_lag=2,
                        version_source=lambda: version["v"])
    for i in range(3):
        q.put(_unroll(t=5, version=0))
    assert q.stats()["frames_pending"] == 15
    version["v"] = 10                       # everything pending is now stale
    q.put(_unroll(t=5, version=9))          # lag 1: admitted
    q.put(_unroll(t=5, version=3))          # lag 7: dropped at admission
    out = q.pop_batch(1, timeout=1.0)       # stale heads purged at pop
    assert len(out) == 1
    s = q.stats()
    assert s["frames_trained"] == 5
    assert s["frames_dropped_stale"] == 20  # 3 aged in queue + 1 at the door
    assert s["frames_pending"] == 0
    assert _ledger_conserved(s), s
    q.close()
    assert _ledger_conserved(q.stats())


def test_queue_overflow_evicts_oldest():
    q = TrajectoryQueue(capacity=2)
    for i in range(4):
        q.put(_unroll(t=3, version=i))
    s = q.stats()
    assert s["frames_dropped_overflow"] == 6
    assert _ledger_conserved(s)
    kept = q.pop_batch(2, timeout=1.0)
    # the two FRESHEST unrolls survived (on-policy keeps fresh data)
    assert [int(u["param_version"]) for u in kept] == [2, 3]


def test_queue_close_drains_pending_and_wakes_consumers():
    q = TrajectoryQueue(capacity=8)
    q.put(_unroll(t=4))
    got = []

    def consumer():
        try:
            q.pop_batch(5)                  # more than will ever arrive
        except Closed:
            got.append("closed")

    t = threading.Thread(target=consumer, daemon=True)
    t.start()
    time.sleep(0.1)
    q.close()
    t.join(timeout=2.0)
    assert not t.is_alive()
    assert got == ["closed"]
    s = q.stats()
    assert s["frames_dropped_shutdown"] == 4
    assert s["frames_pending"] == 0
    assert _ledger_conserved(s)
    q.put(_unroll(t=4))                     # post-close puts are counted too
    assert _ledger_conserved(q.stats())


def test_queue_validation():
    with pytest.raises(ValueError):
        TrajectoryQueue(capacity=0)
    with pytest.raises(ValueError):
        TrajectoryQueue(capacity=4, max_param_lag=-1)
    q = TrajectoryQueue(capacity=4)
    with pytest.raises(ValueError):
        q.pop_batch(0)
    with pytest.raises(TimeoutError):
        q.pop_batch(1, timeout=0.05)


def test_queue_ledger_equals_the_reference():
    """The same random run of puts, pops, version bumps, faults, closes and
    reopens through the port's queue and the reference's gives the same
    ledger after every operation and the same unrolls out."""
    rng = np.random.default_rng(0)
    version = {"v": 0}
    qs = [q(capacity=5, max_param_lag=3, version_source=lambda: version["v"])
          for q in (TrajectoryQueue, JTrajectoryQueue)]
    for _ in range(400):
        op = rng.integers(0, 10)
        if op < 5:
            u = _unroll(t=int(rng.integers(1, 6)),
                        version=int(max(version["v"] - rng.integers(0, 6), 0)),
                        value=float(rng.integers(0, 100)))
            for q in qs:
                q.put(u)
        elif op < 7:
            n = int(rng.integers(1, 4))
            outs = []
            for q in qs:
                try:
                    outs.append([float(u["obs"][0, 0]) for u in q.pop_batch(n, timeout=0)])
                except (TimeoutError, Closed, JClosed) as e:
                    outs.append(type(e).__name__)
            assert outs[0] == outs[1]
        elif op == 7:
            version["v"] += int(rng.integers(1, 3))
        elif op == 8:
            assert qs[0].drop_pending() == qs[1].drop_pending()
        else:
            reopen = rng.random() < 0.7
            for q in qs:
                (q.reopen if reopen else q.close)()
        assert qs[0].stats() == qs[1].stats()
        assert _ledger_conserved(qs[0].stats())
    assert qs[0].stats()["frames_trained"] > 0 and qs[0].stats()["frames_dropped"] > 0


# ---------------------------------------------------------------- batcher

def test_assemble_vtrace_batch_shapes_and_discounts():
    unrolls = [_unroll(t=6, version=i) for i in range(3)]
    unrolls[1]["dones"][2] = 1.0
    batch = assemble_vtrace_batch(unrolls, gamma=0.9)
    assert batch["obs"].shape == (3, 6, 3)
    assert batch["actions"].dtype == np.int32
    assert batch["behavior_logprobs"].shape == (3, 6)
    assert batch["discounts"][1, 2] == 0.0          # terminal cuts
    assert batch["discounts"][0, 0] == pytest.approx(0.9)
    assert batch["param_version"].tolist() == [0, 1, 2]
    with pytest.raises(KeyError):
        bad = _unroll(t=6)
        del bad["behavior_logprobs"]
        assemble_vtrace_batch([bad], gamma=0.9)
    with pytest.raises(ValueError):
        assemble_vtrace_batch([], gamma=0.9)


def test_assemble_vtrace_batch_equals_the_reference():
    """Actor-shaped unrolls (flush_lane_unrolls of a (T, E) run, some
    stamped, dones in the middle): every field, dtype and value equal."""
    rng = np.random.default_rng(1)
    t, e = 7, 5
    stacked = {"obs": rng.standard_normal((t, e, OBS_DIM)).astype(np.float32),
               "actions": rng.integers(0, 3, (t, e)),
               "rewards": rng.choice([-1.0, 0.0, 1.0], (t, e)),
               "dones": rng.random((t, e)) < 0.2,
               "behavior_logprobs": -rng.random((t, e)).astype(np.float32)}
    unrolls = []
    flush_lane_unrolls(stacked, unrolls.append)
    for i, u in enumerate(unrolls[:3]):
        u["param_version"] = np.int64(7 + i)
    for gamma in (0.99, 0.9):
        got, want = assemble_vtrace_batch(unrolls, gamma), jassemble(unrolls, gamma)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_batcher_raises_batch_source_closed():
    q = TrajectoryQueue(capacity=8)
    b = VTraceBatcher(q, batch_size=2, gamma=0.99, poll_timeout_s=0.05)
    q.close()
    with pytest.raises(BatchSourceClosed):
        b()


def test_learner_stop_poisons_blocking_batch_source():
    """A batch_fn blocking on an empty on-policy queue must not hang
    stop()/join(): the poison seam closes the queue and the thread exits
    promptly and cleanly."""
    q = TrajectoryQueue(capacity=8)
    batcher = VTraceBatcher(q, batch_size=4, poll_timeout_s=None)

    def train_step(state, batch):            # never reached
        return state, {}

    lr = Learner(train_step, {"step": 0}, batcher, poison=q.close)
    lr.start()
    time.sleep(0.2)                          # let it block inside pop_batch
    t0 = time.perf_counter()
    lr.stop()
    lr.join(timeout=5.0)
    assert time.perf_counter() - t0 < 2.0, "learner did not stop promptly"
    assert not lr._thread.is_alive()
    assert lr.error is None                  # clean shutdown, not a crash


# --------------------------------------------------- model and train step

def _params(obs_dim=OBS_DIM, num_actions=3, hidden=64, seed=0, scale_wp=1.0):
    """The same params for both packages: JAX's init, converted."""
    jinit, _ = jmlp_actor_critic(obs_dim, num_actions, hidden)
    jp = {k: np.asarray(v) for k, v in jinit(jax.random.PRNGKey(seed)).items()}
    jp["wp"] = (jp["wp"] * scale_wp).astype(np.float32)
    tp = {k: v.requires_grad_(True) for k, v in mlp_params_from_jax(jp).items()}
    return jp, tp


def _batch(b=4, t=8, seed=2):
    rng = np.random.default_rng(seed)
    unrolls = [{"obs": rng.standard_normal((t, OBS_DIM)).astype(np.float32),
                "actions": rng.integers(0, 3, t).astype(np.int32),
                "rewards": rng.choice([-1.0, 0.0, 0.0, 1.0], t).astype(np.float32),
                "dones": (rng.random(t) < 0.15).astype(np.float32),
                "behavior_logprobs": (np.log(1 / 3) + 0.3 * rng.standard_normal(t)
                                      ).astype(np.float32),
                "param_version": np.int64(i)} for i in range(b)]
    return jassemble(unrolls, gamma=0.99)


def test_init_fn_layout_and_seed():
    init_fn, _ = mlp_actor_critic(OBS_DIM, 3, hidden=64)
    p = init_fn(torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w1": (OBS_DIM, 64), "b1": (64,), "wp": (64, 3), "bp": (3,), "wv": (64, 1),
        "bv": (1,)}
    assert all(v.requires_grad and v.dtype == torch.float32 for v in p.values())
    assert not any(p[k].any() for k in ("b1", "bp", "bv"))
    assert abs(float(p["w1"].detach().std()) * np.sqrt(OBS_DIM) - 1.0) < 0.05
    assert 0.007 < float(p["wp"].detach().std()) < 0.013
    q = init_fn(torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(p[k], q[k]) for k in p)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            init_fn(torch.Generator().manual_seed(0))


def test_mlp_actor_critic_matches_jax():
    jp, tp = _params(seed=3, scale_wp=50.0)
    _, japply = jmlp_actor_critic(OBS_DIM, 3)
    _, apply_fn = mlp_actor_critic(OBS_DIM, 3)
    rng = np.random.default_rng(4)
    for shape in ((16, OBS_DIM), (4, 8, OBS_DIM)):
        obs = rng.standard_normal(shape).astype(np.float32)
        jl, jv = japply(jp, jnp.asarray(obs))
        with torch.no_grad():
            tl, tv = apply_fn(tp, torch.from_numpy(obs))
        _close(tl, jl, 1e-6)
        _close(tv, jv, 1e-6)


@pytest.mark.parametrize("steps", [1, 3])
def test_vtrace_train_step_matches_jax(steps):
    """One and three steps on the same batch, adamw(1e-3) on both sides:
    loss, each metric and every param leaf within 1e-5 of its max."""
    jp, tp = _params(seed=5)
    _, japply = jmlp_actor_critic(OBS_DIM, 3)
    _, apply_fn = mlp_actor_critic(OBS_DIM, 3)
    jopt, opt = jadamw(1e-3), adamw(1e-3)
    jstep = jax.jit(jmake_vtrace_train_step(japply, jopt))
    step = make_vtrace_train_step(apply_fn, opt)
    jstate = {"params": jax.tree.map(jnp.asarray, jp), "opt_state": jopt.init(jp),
              "step": jnp.zeros((), jnp.int32)}
    state = {"params": tp, "opt_state": opt.init(tp), "step": 0}
    batch = _batch()
    for _ in range(steps):
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, batch)
    assert state["step"] == steps and state["params"] is tp
    assert sorted(m) == sorted(jm) == ["entropy_loss", "grad_norm", "loss", "mean_rho",
                                       "pg_loss", "value_loss"]
    for k in jm:
        _close(m[k], jm[k], 1e-5)
    for k in jp:
        _close(state["params"][k], jstate["params"][k], 1e-5)
        assert not np.array_equal(state["params"][k].detach().numpy(), jp[k]), k


def test_warmup_does_not_advance_the_state():
    init_fn, apply_fn = mlp_actor_critic(OBS_DIM, 3)
    vl = VTraceLearner(apply_fn, adamw(1e-3))
    state = vl.init_state(init_fn(torch.Generator().manual_seed(0), "cpu"))
    before = {k: v.detach().clone() for k, v in state["params"].items()}
    vl.warmup(state, batch_size=4, unroll=8, obs_shape=(OBS_DIM,))
    assert state["step"] == 0
    assert all(torch.equal(state["params"][k], before[k]) for k in before)
    assert not any(m.any() for m in state["opt_state"]["m"].values())


# ---------------------------------------------------------------- sampling

def test_sampling_policy_logprob_matches_jax():
    jp, tp = _params(seed=6, scale_wp=100.0)
    _, japply = jmlp_actor_critic(OBS_DIM, 3)
    init_fn, apply_fn = mlp_actor_critic(OBS_DIM, 3)
    vl = VTraceLearner(apply_fn, adamw(1e-3))
    policy = vl.sampling_policy(tp, seed=1)
    assert policy.device == torch.device("cpu") and policy.version == 0
    obs = np.random.default_rng(7).standard_normal((64, OBS_DIM)).astype(np.float32)
    out = policy(obs, None)
    assert out.shape == (64, 2) and out.dtype == np.float32
    actions = out[:, 0].astype(np.int64)
    assert np.array_equal(out[:, 0], actions) and set(actions) <= {0, 1, 2}
    jlogits, _ = japply(jp, jnp.asarray(obs))
    want = np.take_along_axis(np.asarray(jax.nn.log_softmax(jlogits)), actions[:, None], 1)[:, 0]
    np.testing.assert_allclose(out[:, 1], want, rtol=0, atol=1e-6)
    # the device-backend adapter: same logprob rule, the core passed through
    policy_apply = vl.device_policy_apply()
    core = object()
    a, lp, c = policy_apply(tp, core, torch.from_numpy(obs), torch.Generator().manual_seed(2))
    assert c is core and a.dtype == torch.int64 and lp.shape == (64,)
    want = np.take_along_axis(np.asarray(jax.nn.log_softmax(jlogits)), a.numpy()[:, None], 1)
    np.testing.assert_allclose(lp.numpy(), want[:, 0], rtol=0, atol=1e-6)
    # and JAX's own adapter gives its logprob by the same rule
    ja, jlp, _ = jmake_device_sampling_policy(japply)(jp, None, jnp.asarray(obs),
                                                     jax.random.PRNGKey(0))
    want = np.take_along_axis(np.asarray(jax.nn.log_softmax(jlogits)),
                              np.asarray(ja)[:, None], 1)[:, 0]
    np.testing.assert_allclose(np.asarray(jlp), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("sampler", ["policy", "device_adapter"])
def test_sampled_action_frequencies_follow_the_softmax(sampler):
    jp, tp = _params(seed=8, scale_wp=150.0)
    _, apply_fn = mlp_actor_critic(OBS_DIM, 3)
    obs = np.random.default_rng(9).standard_normal((1, OBS_DIM)).astype(np.float32)
    many = np.repeat(obs, 20000, axis=0)
    if sampler == "policy":
        actions = SamplingPolicy(apply_fn, tp, seed=3, device="cpu")(many, None)[:, 0]
    else:
        actions, _, _ = make_device_sampling_policy(apply_fn)(
            tp, None, torch.from_numpy(many), torch.Generator().manual_seed(3))
        actions = actions.numpy()
    with torch.no_grad():
        probs = torch.softmax(apply_fn(tp, torch.from_numpy(obs))[0], -1)[0].numpy()
    assert probs.max() - probs.min() > 0.2          # far from uniform
    freq = np.bincount(actions.astype(np.int64), minlength=3) / len(actions)
    np.testing.assert_allclose(freq, probs, rtol=0, atol=0.02)


def test_publish_copies_the_params():
    """The policy never aliases the learner's tensors: after publish, an
    in-place change to them does not move its output; the same seed and
    params give the same draws."""
    _, tp = _params(seed=10, scale_wp=100.0)
    _, apply_fn = mlp_actor_critic(OBS_DIM, 3)
    obs = np.random.default_rng(11).standard_normal((32, OBS_DIM)).astype(np.float32)
    frozen = {k: v.detach().clone() for k, v in tp.items()}
    a = SamplingPolicy(apply_fn, {k: torch.zeros_like(v) for k, v in tp.items()}, seed=4,
                       device="cpu")
    a.publish(tp, 17)
    assert a.version == 17
    with torch.no_grad():
        for v in tp.values():
            v.add_(3.0)
    b = SamplingPolicy(apply_fn, frozen, seed=4, device="cpu")
    assert np.array_equal(a(obs, None), b(obs, None))
    assert not any(a._params[k].data_ptr() == tp[k].data_ptr() for k in tp)


def test_publish_under_concurrent_sampling_gives_one_version_a_batch():
    """A publisher alternates two param sets while samplers call the
    policy: every batch's logprobs are those of one set, never a mix."""
    _, apply_fn = mlp_actor_critic(OBS_DIM, 3)
    sets = [_params(seed=s, scale_wp=100.0)[1] for s in (12, 13)]
    policy = SamplingPolicy(apply_fn, sets[0], seed=5, device="cpu")
    obs = np.random.default_rng(14).standard_normal((16, OBS_DIM)).astype(np.float32)
    with torch.no_grad():
        lps = [torch.log_softmax(apply_fn(p, torch.from_numpy(obs))[0], -1).numpy()
               for p in sets]
    stop = threading.Event()
    torn, batches = [], []

    def publisher():
        v = 0
        while not stop.is_set():
            policy.publish(sets[v % 2], v)
            v += 1

    def sampler():
        while not stop.is_set():
            out = policy(obs, None)
            a = out[:, 0].astype(np.int64)
            match = [np.allclose(out[:, 1], lp[np.arange(16), a], atol=1e-6) for lp in lps]
            batches.append(1)
            if not any(match):
                torn.append(out)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=publisher)] + [
        threading.Thread(target=sampler) for _ in range(3)]
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
    assert batches and not torn, len(torn)


# ------------------------------------------------------------------ Catch

def _all_states(rows, cols):
    """Every (ball_r, ball_c, paddle) a live episode can be in, each with
    each action: lanes about to end included."""
    grid = np.array([(r, c, p, a) for r in range(rows - 1) for c in range(cols)
                     for p in range(cols) for a in range(3)])
    return grid.T


@pytest.mark.parametrize("rows, cols", [(10, 5), (6, 4)])
def test_catch_step_matches_jax(rows, cols):
    """Catch's step on the same injected states and every action: reward
    and done equal on every lane; obs equal on every lane that goes on; a
    lane that ends restarts at row 0 with its draws in range."""
    br, bc, pd, act = _all_states(rows, cols)
    n = br.shape[0]
    jenv, env = JCatchEnv(rows, cols), CatchEnv(rows, cols, device="cpu")
    jst = JCatchState(jnp.asarray(br, jnp.int32), jnp.asarray(bc, jnp.int32),
                      jnp.asarray(pd, jnp.int32), jax.random.split(jax.random.PRNGKey(0), n))
    _, jobs, jrew, jdone = jax.vmap(jenv.step)(jst, jnp.asarray(act, jnp.int32))
    st = CatchState(*(torch.from_numpy(x.astype(np.int64)) for x in (br, bc, pd)))
    new, obs, rew, done = env.step(st, torch.from_numpy(act.astype(np.int64)),
                                   torch.Generator().manual_seed(0))
    assert obs.shape == (n, rows * cols) and obs.dtype == torch.float32
    assert rew.dtype == torch.float32 and done.dtype == torch.bool
    assert np.array_equal(rew.numpy(), np.asarray(jrew))
    assert np.array_equal(done.numpy(), np.asarray(jdone))
    d = done.numpy()
    assert 0 < d.sum() < n
    assert np.array_equal(obs.numpy()[~d], np.asarray(jobs)[~d])
    assert torch.equal(obs, env.obs(new))
    assert (new.ball_r[done] == 0).all() and (new.ball_c >= 0).all() \
        and (new.ball_c < cols).all() and (new.paddle >= 0).all() and (new.paddle < cols).all()
    # JAX's obs of an ended lane is a one-hot grid of the same form
    jo = np.asarray(jobs)[d].reshape(-1, rows, cols)
    assert (jo[:, 0].sum(1) == 1).all() and (jo[:, -1].sum(1) == 1).all()
    assert (obs.numpy()[d].reshape(-1, rows, cols)[:, 0].sum(1) == 1).all()


def test_catch_reset_and_auto_reset_draws():
    env = CatchEnv(device="cpu")
    gen = torch.Generator().manual_seed(0)
    st, obs = env.reset(20000, gen)
    assert (st.ball_r == 0).all() and obs.shape == (20000, 50)
    for x in (st.ball_c, st.paddle):
        freq = np.bincount(x.numpy(), minlength=5) / 20000
        np.testing.assert_allclose(freq, 0.2, atol=0.02)
    # the obs agrees with JAX's obs of the same state
    jenv = JCatchEnv()
    jst = JCatchState(jnp.asarray(st.ball_r[:64].numpy(), jnp.int32),
                      jnp.asarray(st.ball_c[:64].numpy(), jnp.int32),
                      jnp.asarray(st.paddle[:64].numpy(), jnp.int32),
                      jax.random.split(jax.random.PRNGKey(0), 64))
    assert np.array_equal(obs[:64].numpy(), np.asarray(jax.vmap(jenv._obs)(jst)))


def test_torch_vector_env_via_make_vector_env():
    vec = make_vector_env(_catch, 3, seed=4)
    assert isinstance(vec, TorchVectorEnv) and vec.num_envs == 3
    assert vec.obs_shape == (50,) and vec.num_actions == 3
    assert isinstance(make_vector_env(_catch(), 2), TorchVectorEnv)   # pre-built: stateless
    obs = vec.reset()
    assert obs.shape == (3, 50) and obs.dtype == np.float32
    dones, rewards = 0, []
    for i in range(27):
        obs, r, d = vec.step(np.full(3, i % 3))
        assert obs.shape == (3, 50) and r.dtype == np.float32 and d.dtype == bool
        assert ((r != 0) == d).all()          # rewards only at an episode's end
        dones += int(d.sum())
        rewards += list(r[d])
        # every lane goes on: one ball and one paddle on the grid
        assert (obs.reshape(3, 10, 5)[:, -1].sum(1) >= 1).all()
    assert dones == 9 and set(rewards) <= {-1.0, 1.0}      # 3 lanes, every 9 steps
    # seeded per actor: the same seed draws the same lanes, another seed others
    a, b, c = (make_vector_env(_catch, 64, seed=s).reset() for s in (1, 1, 2))
    assert np.array_equal(a, b) and not np.array_equal(a, c)


# ------------------------------------------------------- learning anchor

def test_vtrace_train_step_learns_catch():
    """Threadless loop: Catch lanes on the device -> SamplingPolicy ->
    flush_lane_unrolls -> assemble_vtrace_batch -> train step; the average
    episode reward on Catch must clearly improve (the reference's bounds)."""
    env = CatchEnv(rows=6, cols=4, device="cpu")
    init_fn, apply_fn = mlp_actor_critic(24, 3, hidden=32)
    vl = VTraceLearner(apply_fn, adamw(3e-3), entropy_coef=0.003)
    state = vl.init_state(init_fn(torch.Generator().manual_seed(0), "cpu"))
    policy = vl.sampling_policy(state["params"], seed=0)
    vec = TorchVectorEnv(env, 16, seed=0)

    def avg_return(params, seed):
        ev, pol = TorchVectorEnv(env, 16, seed=seed), SamplingPolicy(apply_fn, params, seed, "cpu")
        obs, rewards, dones = ev.reset(), 0.0, 0
        for _ in range(30):
            obs, r, d = ev.step(pol(obs, None)[:, 0].astype(np.int32))
            rewards, dones = rewards + float(r.sum()), dones + int(d.sum())
        return rewards / max(dones, 1)

    before = avg_return(state["params"], seed=101)
    obs = vec.reset()
    for i in range(150):
        buf = {k: [] for k in ("obs", "actions", "rewards", "dones", "behavior_logprobs")}
        for _ in range(12):
            out = policy(obs, None)
            actions = out[:, 0].astype(np.int32)
            nobs, r, d = vec.step(actions)
            for k, v in zip(buf, (obs, actions, r, d, out[:, 1])):
                buf[k].append(v)
            obs = nobs
        unrolls = []
        flush_lane_unrolls({k: np.stack(v) for k, v in buf.items()}, unrolls.append)
        state, metrics = vl.train_step(state, assemble_vtrace_batch(unrolls, gamma=0.95))
        policy.publish(state["params"], state["step"])
    assert np.isfinite(float(metrics["loss"]))
    after = avg_return(state["params"], seed=101)
    assert after > before + 0.3, (before, after)
    assert after > 0.2, (before, after)


# ------------------------------------------------ SeedSystem(algo="vtrace")

def _vtrace_system(**kw):
    init_fn, apply_fn = mlp_actor_critic(OBS_DIM, 3)
    vl = VTraceLearner(apply_fn, adamw(1e-3))
    state = vl.init_state(init_fn(torch.Generator().manual_seed(0), "cpu"))
    policy = vl.sampling_policy(state["params"])
    return SeedSystem(env_factory=_catch, policy_step=policy, num_actors=2, unroll=8,
                      envs_per_actor=4, deadline_ms=1.0, algo="vtrace",
                      train_step=vl.train_step, state=state, learner_batch=4,
                      policy_publish=policy.publish, **kw), policy


def _assert_trained_and_conserved(stats):
    assert stats["learner_error"] is None, stats["learner_error"]
    assert stats["inference_error"] is None, stats["inference_error"]
    assert stats["learner_steps"] > 0, stats
    onp = stats["onpolicy"]
    assert _ledger_conserved(onp), onp
    assert onp["frames_pending"] == 0, onp
    assert onp["frames_trained"] > 0, onp
    assert onp["frames_generated"] == onp["frames_trained"] + onp["frames_dropped"]
    assert stats["mean_param_lag"] >= 0.0


def test_vtrace_trains_inproc_host_backend():
    sys_, policy = _vtrace_system(max_param_lag=50)
    sys_.warmup()
    stats = sys_.run(seconds=2.0)
    _assert_trained_and_conserved(stats)
    assert stats["algo"] == "vtrace"
    assert stats["unroll_flushes"] > 0
    assert stats["env_frames"] == stats["actor_iterations"] * 4
    assert stats["onpolicy"]["capacity"] == 64 and stats["onpolicy"]["max_param_lag"] == 50
    # every admitted frame came from an unroll of 8 steps of one lane
    assert stats["onpolicy"]["frames_generated"] == stats["unroll_flushes"] * 4 * 8
    assert policy.version == stats["learner_steps"] == sys_.learner.state["step"]
    assert stats["recovery"]["frames_dropped_by_fault"] == 0


def test_vtrace_resume_reopens_the_queue(tmp_path):
    sys_, policy = _vtrace_system(max_param_lag=50, checkpoint_dir=str(tmp_path),
                                  checkpoint_every=1)
    first = sys_.run(seconds=1.5)
    _assert_trained_and_conserved(first)
    sys_.learner.ckpt.wait()
    q = sys_.onpolicy_queue
    q.put(_unroll(t=8, version=first["learner_steps"]))    # closed: counted as a drop
    assert q.stats()["frames_dropped_shutdown"] == first["onpolicy"][
        "frames_dropped_shutdown"] + 8
    version = sys_.resume()
    assert version == sys_.learner.steps and policy.version == version
    q.put(_unroll(t=8, version=version))                   # reopened: admitted
    assert q.stats()["frames_pending"] == 8
    q.drop_pending()
    second = sys_.run(seconds=1.5)
    _assert_trained_and_conserved(second)
    onp = second["onpolicy"]
    assert onp["frames_generated"] > first["onpolicy"]["frames_generated"] + 16
    assert onp["frames_dropped_fault"] == 8
    assert second["recovery"]["frames_dropped_by_fault"] == 8
    assert second["recovery"]["checkpoint_restores"] == 1


def test_r2d2_default_keeps_the_zero_ledger():
    def det_policy(obs, ids):
        return (np.abs(obs.reshape(obs.shape[0], -1)).sum(axis=1) * 31.0).astype(np.int64) % 3

    sys_ = SeedSystem(env_factory=_catch, policy_step=det_policy, num_actors=2, unroll=4,
                      envs_per_actor=2, deadline_ms=1.0)
    assert sys_.onpolicy_queue is None
    sys_.warmup()
    stats = sys_.run(seconds=0.5, with_learner=False)
    assert stats["algo"] == "r2d2" and stats["env_frames"] > 0
    assert stats["onpolicy"] == ZERO_LEDGER
    assert stats["mean_param_lag"] == 0.0
    batch, idx, w = sys_.replay.sample(2)
    assert sorted(batch) == ["actions", "dones", "obs", "rewards"]


def _message(cls, env_factory, **kw):
    with pytest.raises(ValueError) as e:
        cls(env_factory=env_factory, policy_step=lambda o, i: None, num_actors=1, unroll=4,
            **kw)
    return str(e.value)


@pytest.mark.parametrize("kw", [{"algo": "ppo"}, {"max_param_lag": 3}, {"queue_capacity": 8},
                                {"gamma": 0.9}, {"algo": "vtrace", "backend": "device"}])
def test_algo_validation_messages_as_the_reference(kw):
    assert _message(SeedSystem, _catch, **kw) == _message(JSeedSystem, JCatchEnv, **kw)


@pytest.mark.parametrize("kw", [
    {"telemetry": object()}, {"ops_port": 0}, {"autoscale": object()},
    {"transport": "socket", "telemetry": object()},
    {"transport": "shm", "autoscale": object()}])
def test_vtrace_keeps_the_unported_branches_refused(kw):
    """The ops branches on the V-trace plane, held to the reference (the
    name predates their port): the same exception type and message (with
    the package's own name) for a wrong `telemetry` or `autoscale`, and
    ``ops_port=0`` builds and binds in both packages."""
    def outcome(cls, env_factory):
        try:
            system = cls(env_factory=env_factory, policy_step=lambda o, i: None,
                         num_actors=1, unroll=4, algo="vtrace", **kw)
        except Exception as e:              # noqa: BLE001 — compared below
            return type(e), str(e)
        bound = system.ops_address is not None and system.ops_address[1] > 0
        system.stop_ops()
        return "built", bound
    got, want = outcome(SeedSystem, _catch), outcome(JSeedSystem, JCatchEnv)
    assert got[0] is want[0]
    if got[0] == "built":
        assert got[1] is True and want[1] is True
    else:
        assert got[0] is TypeError
        assert got[1].replace("repro_torch.", "repro.") == want[1]


# ---------------------------------------------------------------- launcher

def _cli(*args):
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train_vtrace", *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=240, env=env)


def test_cli_runs_on_the_cpu_and_prints_ok():
    res = _cli("--device", "cpu", "--actors", "1", "2", "--seconds", "1.5")
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.splitlines()
    assert lines[-1].startswith("ok — frame ledger conserved")
    rows = [line for line in lines if line.startswith("fig3f_vtrace_actors_")]
    assert [r.split(",")[0] for r in rows] == ["fig3f_vtrace_actors_1", "fig3f_vtrace_actors_2"]


def test_cli_without_device_raises_where_there_is_no_card():
    res = _cli("--seconds", "1")
    assert res.returncode != 0
    assert "torch.cuda.is_available() is False" in res.stderr
    assert "ok" not in res.stdout


def test_build_starts_every_point_from_the_same_params():
    a, b = (train_vtrace.build(n, device="cpu", seed=3) for n in (1, 2))
    for run in (a, b):
        assert run.system.algo == "vtrace" and run.learner.train_step is not None
        assert run.system.learner.state["step"] == 0
    pa, pb = a.system.learner.state["params"], b.system.learner.state["params"]
    assert all(torch.equal(pa[k], pb[k]) and torch.equal(a.policy._params[k], pa[k])
               for k in pa)
