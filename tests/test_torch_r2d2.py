"""The port's R2D2 agent and loss against the JAX package, on the CPU.

The same inputs, drawn from a seeded numpy generator, go through both
packages: params in the reference's tree, drawn at its init's scale with
every bias non-zero (so that a bias added to the wrong gate or head
shows), converted by ``params_from_jax``. All fp32.

Tolerances:
- the conv-LSTM forward and step (q-values, the final h and c): 1e-5 of
  the output's max |value|; the convolutions and products differ only in
  summation order (oneDNN and BLAS against XLA), ~1e-7 relative a layer;
- the LSTM cell and scan, rescale and its inverse, n-step targets and the
  R2D2 loss on shared q-values: 1e-5 (1e-4 for inv_rescale, which
  amplifies its input's rounding by up to ~2 |x| / eps);
- the loss and every gradient leaf of ``make_r2d2_loss``: 1e-4 of the
  leaf's max |g| (a backward through 19 LSTM steps, three convolutions
  and the heads);
- params after an AdamW step: as ``tests/test_torch_train.py`` states it
  (within 2 lr everywhere, within 1e-3 lr where the moment is at least
  1e-3 of its leaf's max).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.r2d2_atari import AtariConfig as JAtariConfig  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.core import r2d2 as jr2d2  # noqa: E402
from repro.models import atari as jatari  # noqa: E402
from repro.nn import recurrent as jrecurrent  # noqa: E402
from repro.optim.adamw import adamw as jadamw  # noqa: E402
from repro_torch.configs.r2d2_atari import AtariConfig  # noqa: E402
from repro_torch.configs.registry import get_config, make_model  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import losses, r2d2  # noqa: E402
from repro_torch.models import atari  # noqa: E402
from repro_torch.nn import recurrent  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

torch.set_num_threads(1)

# frame 52 leaves a 3 x 3 x 64 torso output, so a flatten in the wrong
# order (C, H, W) reads torso_out.w's rows wrongly; 3 channels differ from
# both spatial sizes
SMALL = dict(obs_size=52, obs_channels=3, core_dim=32, num_actions=6, burn_in=3,
             unroll=10, n_step=3, target_update_period=2)
LR = 1e-3


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=tol, rtol=tol)


def _close_leaf(got, want, tol):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(_np(got), want, atol=tol * scale, rtol=tol)


def _configs(**fields):
    return JAtariConfig(**fields), AtariConfig(**fields)


def _params(jcfg, cfg, seed=0):
    """JAX params in the reference's tree (its shapes, from ``jax.eval_shape``
    of its init) drawn from a seeded numpy generator: each weight N(0, 1 /
    fan_in), as the reference's init scales them, and each bias N(0,
    0.1^2), not zero; and the port's module holding the same values."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jatari.make_atari(jcfg).init, jax.random.PRNGKey(seed))

    def draw(x):
        scale = 0.1 if len(x.shape) == 1 else 1.0 / np.sqrt(np.prod(x.shape[:-1]))
        return (scale * rng.standard_normal(x.shape)).astype(np.float32)
    jp = jax.tree.map(draw, shapes)
    module = make_model(cfg).init(seed, device="cpu")
    module.load_state_dict(params_from_jax(cfg, jp))
    return jax.tree.map(jnp.asarray, jp), module


def _obs(rng, shape, as_uint8):
    if as_uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.random(shape, dtype=np.float32)


def _core(rng, b, d):
    return tuple((0.5 * rng.standard_normal((b, d))).astype(np.float32) for _ in range(2))


def test_registry_and_param_layout():
    cfg = get_config("r2d2-atari")
    assert cfg == AtariConfig() and cfg.family == "atari"
    jcfg, cfg = _configs()
    shapes = jax.eval_shape(jatari.make_atari(jcfg).init, jax.random.PRNGKey(0))
    sd = params_from_jax(cfg, jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), shapes))
    module = make_model(cfg).init(0, device="cpu")
    assert {k: tuple(v.shape) for k, v in module.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    assert tuple(sd["torso_out.w"].shape) == (3136, 512)
    assert not any(p.requires_grad for p in module.parameters())


@pytest.mark.parametrize("case", ["small-uint8", "small-float-core", "full-uint8"])
def test_atari_forward_matches_jax(case):
    """q-values (B,T,A) and the final (h, c) of the unrolled agent."""
    size, obs_kind, *core = case.split("-")
    jcfg, cfg = _configs(**(SMALL if size == "small" else {}))
    jp, params = _params(jcfg, cfg)
    rng = np.random.default_rng(1)
    b, t = (3, 5) if size == "small" else (2, 3)
    batch = {"obs": _obs(rng, (b, t, cfg.obs_size, cfg.obs_size, cfg.obs_channels),
                         obs_kind == "uint8")}
    if core:
        batch["core"] = _core(rng, b, cfg.core_dim)
    jout, (jh, jc) = jatari.atari_forward(jcfg, jp, jax.tree.map(jnp.asarray, batch))
    tb = {"obs": torch.from_numpy(batch["obs"])}
    if core:
        tb["core"] = tuple(map(torch.from_numpy, batch["core"]))
    out, (h, c) = atari.atari_forward(cfg, params, tb)
    assert out.logits.shape == (b, t, cfg.num_actions) and out.logits.dtype == torch.float32
    _close_leaf(out.logits, jout.logits, 1e-5)
    _close_leaf(out.value, jout.value, 1e-5)
    _close_leaf(h, jh, 1e-5)
    _close_leaf(c, jc, 1e-5)
    assert float(np.abs(np.asarray(jout.logits)).max()) > 1e-3


def test_atari_step_matches_jax():
    """decode_step, the actor's one-frame inference, from a given state."""
    jcfg, cfg = _configs(**SMALL)
    jp, params = _params(jcfg, cfg)
    rng = np.random.default_rng(2)
    obs = _obs(rng, (4, cfg.obs_size, cfg.obs_size, cfg.obs_channels), True)
    state = _core(rng, 4, cfg.core_dim)
    jq, (jh, jc) = jatari.make_atari(jcfg).decode_step(jp, jnp.asarray(obs),
                                                       tuple(map(jnp.asarray, state)))
    bundle = make_model(cfg)
    q, (h, c) = bundle.decode_step(params, torch.from_numpy(obs),
                                   tuple(map(torch.from_numpy, state)))
    _close_leaf(q, jq, 1e-5)
    _close_leaf(h, jh, 1e-5)
    _close_leaf(c, jc, 1e-5)
    h0, c0 = bundle.init_cache(4, device="cpu")
    assert h0.shape == c0.shape == (4, cfg.core_dim) and not h0.any()


def test_lstm_step_and_scan_match_jax():
    d_in, d, b, t = 12, 8, 3, 7
    rng = np.random.default_rng(3)
    p = {"wi": rng.standard_normal((d_in, 4 * d)).astype(np.float32) * 0.3,
         "wh": rng.standard_normal((d, 4 * d)).astype(np.float32) * 0.3,
         "b": rng.standard_normal(4 * d).astype(np.float32) * 0.3}
    cell = recurrent.LSTM(d_in, d)
    cell.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    xs = rng.standard_normal((b, t, d_in)).astype(np.float32)
    state = _core(rng, b, d)
    jh, (_, jc) = jrecurrent.lstm_step(p, xs[:, 0], state)
    h, (_, c) = recurrent.lstm_step(cell, torch.from_numpy(xs[:, 0]),
                                    tuple(map(torch.from_numpy, state)))
    _close(h, jh, 1e-5)
    _close(c, jc, 1e-5)
    jhs, (jh, jc) = jrecurrent.lstm_scan(p, xs, state)
    hs, (h, c) = recurrent.lstm_scan(cell, torch.from_numpy(xs),
                                     tuple(map(torch.from_numpy, state)))
    assert hs.shape == (b, t, d)
    _close(hs, jhs, 1e-5)
    _close(h, jh, 1e-5)
    _close(c, jc, 1e-5)
    z = recurrent.lstm_state_init(b, d, device="cpu")
    assert all(s.shape == (b, d) and not s.any() for s in z)


def test_rescale_and_inverse_match_jax():
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.standard_normal(200) * 10.0, rng.standard_normal(200) * 1e3,
                        [0.0, -1e4, 1e4]]).astype(np.float32)
    _close(r2d2.rescale(torch.from_numpy(x)), jr2d2.rescale(jnp.asarray(x)), 1e-5)
    _close(r2d2.inv_rescale(torch.from_numpy(x)), jr2d2.inv_rescale(jnp.asarray(x)), 1e-4)
    back = r2d2.inv_rescale(r2d2.rescale(torch.from_numpy(x))).numpy()
    assert np.all(np.abs(back - x) < 1e-2 + 1e-3 * np.abs(x))


def _rl_inputs(seed, b=2, t=9, a=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, a)).astype(np.float32),
            rng.standard_normal((b, t, a)).astype(np.float32),
            rng.integers(0, a, (b, t)).astype(np.int32),
            rng.standard_normal((b, t)).astype(np.float32),
            (rng.random((b, t)) < 0.15).astype(np.float32))


def test_n_step_targets_match_jax_and_naive():
    """The reference's function and the naive loop of the reference's
    ``tests/test_rl_core.py``, on the same inputs."""
    n, gamma = 3, 0.9
    qt, qo, actions, rewards, dones = _rl_inputs(5)
    got = r2d2.n_step_targets(*map(torch.from_numpy, (qt, qo, actions, rewards, dones)),
                              n_step=n, gamma=gamma)
    want = jr2d2.n_step_targets(*map(jnp.asarray, (qt, qo, actions, rewards, dones)),
                                n_step=n, gamma=gamma)
    _close(got, want, 1e-5)
    b, t = rewards.shape
    best = qo.argmax(-1)
    qnext = r2d2.inv_rescale(torch.from_numpy(
        np.take_along_axis(qt, best[..., None], -1)[..., 0])).numpy()
    expected = np.zeros((b, t - n))
    for bi in range(b):
        for ti in range(t - n):
            ret, disc, alive = 0.0, 1.0, 1.0
            for i in range(n):
                ret += disc * alive * rewards[bi, ti + i]
                alive *= 1.0 - dones[bi, ti + i]
                disc *= gamma
            ret += disc * alive * qnext[bi, ti + n]
            expected[bi, ti] = float(r2d2.rescale(torch.tensor(ret)))
    np.testing.assert_allclose(got.numpy(), expected, atol=1e-4)


def test_double_q_takes_the_first_of_tied_maxima():
    q_online = torch.zeros(1, 4, 3)     # every action ties
    q_target = torch.arange(12.0).reshape(1, 4, 3)
    got = r2d2.n_step_targets(q_target, q_online, torch.zeros(1, 4, dtype=torch.int32),
                              torch.zeros(1, 4), torch.zeros(1, 4), n_step=1, gamma=1.0)
    want = jr2d2.n_step_targets(jnp.asarray(q_target.numpy()), jnp.zeros((1, 4, 3)),
                                jnp.zeros((1, 4), jnp.int32), jnp.zeros((1, 4)),
                                jnp.zeros((1, 4)), n_step=1, gamma=1.0)
    _close(got, want, 1e-6)


def test_r2d2_loss_matches_jax():
    qt, qo, actions, rewards, dones = _rl_inputs(6, b=3, t=12, a=5)
    kw = dict(n_step=4, gamma=0.97, priority_exponent=0.9)
    tq = torch.from_numpy(qo).requires_grad_(True)
    got = r2d2.r2d2_loss(None, tq, *map(torch.from_numpy, (qt, actions, rewards, dones)),
                         **kw)
    want = jr2d2.r2d2_loss(None, *map(jnp.asarray, (qo, qt, actions, rewards, dones)), **kw)
    _close(got.loss, want.loss, 1e-5)
    _close(got.priorities, want.priorities, 1e-5)
    _close(got.td_error, want.td_error, 1e-5)
    assert got.loss.requires_grad
    assert got.priorities.grad_fn is None and got.td_error.grad_fn is None


def _replay_batch(cfg, b, seed, with_weights):
    rng = np.random.default_rng(seed)
    t = cfg.burn_in + cfg.unroll
    batch = {"obs": _obs(rng, (b, t, cfg.obs_size, cfg.obs_size, cfg.obs_channels), True),
             "actions": rng.integers(0, cfg.num_actions, (b, t)).astype(np.int32),
             "rewards": rng.standard_normal((b, t)).astype(np.float32),
             "dones": (rng.random((b, t)) < 0.1).astype(np.float32),
             "core": _core(rng, b, cfg.core_dim)}
    if with_weights:
        batch["is_weights"] = rng.uniform(0.2, 1.0, b).astype(np.float32)
    return batch


def _to_torch(batch):
    return {k: tuple(map(torch.from_numpy, v)) if k == "core" else torch.from_numpy(v)
            for k, v in batch.items()}


def _target(jp, scale=0.9):
    """A target net that differs from the online one."""
    return jax.tree.map(lambda x: x * scale, jp)


@pytest.mark.parametrize("with_weights", [False, True], ids=["plain", "is_weights"])
def test_make_r2d2_loss_and_every_gradient_match_jax(with_weights):
    """Loss, priorities and every gradient leaf against ``jax.value_and_grad``
    of the reference's loss. With is_weights the reference's loss is built
    from the td_error that ``r2d2_loss`` returns under stop_gradient, so
    its gradient is exactly zero (ROADMAP section 3): both packages are
    held to that, and the plain case holds every leaf to a live gradient."""
    jcfg, cfg = _configs(**SMALL)
    jp, params = _params(jcfg, cfg)
    jtp = _target(jp)
    target = make_model(cfg).init(0, device="cpu")
    target.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jtp)))
    params.requires_grad_(True)
    batch = _replay_batch(cfg, 3, 7, with_weights)
    jloss = jlosses.make_r2d2_loss(jatari.make_atari(jcfg), jcfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jp, jtp, jax.tree.map(jnp.asarray, batch))
    loss, metrics = losses.make_r2d2_loss(make_model(cfg), cfg)(params, target, _to_torch(batch))
    _close(loss, jl, 1e-5)
    _close(metrics["loss"], jm["loss"], 1e-5)
    _close(metrics["priorities"], jm["priorities"], 1e-5)
    named = dict(params.named_parameters())
    grads = losses.param_grads(loss, named)
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jg))
    assert set(grads) == set(want) and len(want) == 15
    for name, g in grads.items():
        _close_leaf(g, want[name].numpy(), 1e-4)
    if with_weights:
        assert not loss.requires_grad
        assert all(float(w.abs().max()) == 0.0 for w in want.values())
    else:
        assert all(float(w.abs().max()) > 0 for w in want.values()), \
            "a gradient leaf is all zeros: the check would not see a missing path"


def test_train_step_adamw_and_target_sync_match_jax():
    """Two R2D2 train steps (AdamW at lr 1e-3, target_update_period 2)
    against the reference's jitted step: params after each step; the
    target unchanged after step 1 and equal to the params after step 2."""
    jcfg, cfg = _configs(**SMALL)
    jp, params = _params(jcfg, cfg)
    jbundle, bundle = jatari.make_atari(jcfg), make_model(cfg)
    jopt, opt = jadamw(LR), adamw(LR)
    jstep = jax.jit(jlosses.make_train_step(jbundle, jopt, algo="r2d2", acfg=jcfg))
    jstate = {"params": jp, "opt_state": jopt.init(jp), "step": jnp.zeros((), jnp.int32),
              "target": _target(jp)}
    state = losses.init_train_state(bundle, opt, 0, "cpu", with_target=True)
    state["params"].load_state_dict(params.state_dict())
    state["target"].load_state_dict(params_from_jax(
        cfg, jax.tree.map(np.asarray, jstate["target"])))
    assert all(t.data_ptr() != p.data_ptr() for t, p in
               zip(state["target"].parameters(), state["params"].parameters()))
    target0 = {k: v.clone() for k, v in state["target"].state_dict().items()}
    step = losses.make_train_step(bundle, opt, algo="r2d2", acfg=cfg)
    settled = {}     # elements whose moment was settled at every step so far
    for i in (1, 2):
        batch = _replay_batch(cfg, 2, 10 + i, with_weights=False)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, metrics = step(state, _to_torch(batch))
        assert state["step"] == int(jstate["step"]) == i
        _close(metrics["loss"], jm["loss"], 1e-4)
        _close(metrics["grad_norm"], jm["grad_norm"], 1e-4)
        jparams = params_from_jax(cfg, jax.tree.map(np.asarray, jstate["params"]))
        jm1 = params_from_jax(cfg, jax.tree.map(np.asarray, jstate["opt_state"]["m"]))
        for name, p in state["params"].named_parameters():
            got, want = _np(p), jparams[name].numpy()
            m = jm1[name].numpy()
            settled[name] = settled.get(name, True) & (
                np.abs(m) >= 1e-3 * max(float(np.abs(m).max()), 1e-30))
            diff = np.abs(got - want)
            assert diff.max() <= 2 * LR * i + 1e-6, name
            assert diff[settled[name]].max(initial=0.0) <= 1e-3 * LR * i + 1e-6, name
        jtarget = params_from_jax(cfg, jax.tree.map(np.asarray, jstate["target"]))
        for name, t in state["target"].state_dict().items():
            if i == 1:
                assert torch.equal(t, target0[name]), name
            else:
                assert torch.equal(t, dict(state["params"].named_parameters())[name]), name
            np.testing.assert_allclose(_np(t), jtarget[name].numpy(), atol=2 * LR * i + 1e-6)
    assert not any(p.requires_grad for p in state["target"].parameters())
