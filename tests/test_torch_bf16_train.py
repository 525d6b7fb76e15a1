"""One V-trace train step at the reference's production dtypes, the port
against the JAX package on the CPU.

The reference's ``production_config`` (``repro.launch.dryrun``) trains
every cell with bf16 params and compute, full remat and fp32 AdamW
moments; qwen3-14b with its config's gradient accumulation, mamba2-2.7b
(pure data-parallel) without. Here: the smoke configs of both with those
dtypes, qwen3's at ``grad_accum=2``, the same params in both packages (the
port's init in bf16, laid out in the JAX tree by ``test_torch_train``'s
``_params``), the batch JAX drew. The
JAX side runs its plain paths (``attend_ref``, ``ssd_chunked``) under
``jax.checkpoint``; the port's CPU path is its kernels' plain versions
under ``torch.utils.checkpoint``. On the card the same step runs K1 and
K1-bwd, or K3 and K3-bwd, on their bf16 routes (``chip_smoke.py``).

Tolerances, against bf16 compute rounding at other places in the two
frameworks (the fp32 tests in ``test_torch_train.py`` hold 1e-4):
- the loss within 1e-2 relative;
- every gradient leaf (bf16, the params' dtype) within 5e-2 of its max of
  JAX's, or, where bf16's rounding noise alone is larger than that, within
  BF16_NOISE of its max of the same gradient taken in fp32 (the port's
  plain path on fp32 params of the same values, which
  ``test_torch_train.py`` holds to JAX's fp32 gradient at 1e-4). At these
  sizes a leaf is a sum with much cancellation, and bf16 compute moves it
  by 2-9% of its max from the fp32 gradient in either package: JAX's own
  bf16 leaves sit up to 0.07 of their max from it (qwen3's value_head.b
  0.37), the port's up to 0.09, and the two packages' leaves differ by
  more than 5e-2 on a few leaves whichever package is nearer to fp32. A
  wrong mask, cast or gradient path moves a leaf by far more;
- the params after one AdamW step within 2 lr plus one bf16 ulp of each
  element: at step 0 AdamW moves an element by at most lr, the two steps'
  updates differ by at most 2 lr, and the bf16 sum rounds once.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import make_model as jmake_model  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke_config  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.envs.tokenworld import synthetic_vtrace_batch as jbatch  # noqa: E402
from repro.optim.adamw import adamw as jadamw  # noqa: E402
from repro_torch.configs.registry import make_model, smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import losses  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from test_torch_train import _np, _params, _port_state, _to_torch  # noqa: E402

B, S = 2, 40        # 3 of mamba2's 16-step smoke chunks, ragged
LR = 1e-3
BF16_NOISE = 1e-1   # of a leaf's max: bf16 compute's distance from the fp32 gradient
PRODUCTION = dict(param_dtype="bfloat16", compute_dtype="bfloat16", remat="full",
                  optimizer_dtype="float32")
ARCHS = {"qwen3-14b": dict(grad_accum=2), "mamba2-2.7b": {}}


@pytest.fixture(scope="module", params=list(ARCHS))
def setup(request):
    """Both packages' bundles at the production dtypes, the same params and
    the batch JAX drew."""
    arch = request.param
    over = dict(PRODUCTION, **ARCHS[arch])
    jcfg, cfg = jsmoke_config(arch).with_(**over), smoke_config(arch).with_(**over)
    assert cfg == cfg.with_(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    jbundle, bundle = jmake_model(jcfg), make_model(cfg)
    jparams, sd = _params(jbundle, bundle)   # the port's bf16 init, embedding table x 0.1
    assert all(t.dtype == torch.bfloat16 for t in sd.values())
    batch = jax.tree.map(np.asarray, jbatch(jax.random.PRNGKey(1), B, S, cfg.vocab_size))
    return arch, jbundle, jparams, bundle, sd, batch


def _grads(bundle, sd, batch):
    """The port's V-trace loss and its gradient leaves on params `sd`."""
    params = _port_state(bundle, sd, adamw(LR))["params"]
    loss, _ = losses.make_vtrace_loss(bundle)(params, _to_torch(batch))
    return loss.detach(), losses.param_grads(loss, dict(params.named_parameters()))


def _dist(got, ref):
    """max |got - ref| over max |ref|."""
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max() / max(np.abs(ref).max(), 1e-30))


def test_loss_and_every_gradient_match_jax(setup):
    """The V-trace loss and every gradient leaf of the whole batch, bf16
    params and compute under full remat, against jax.value_and_grad of the
    same: loss within 1e-2 relative; each leaf within 5e-2 of its max of
    JAX's, or within BF16_NOISE of its max of the fp32 gradient (see the
    module's note), where fewer than a quarter of the leaves may go."""
    arch, jbundle, jparams, bundle, sd, batch = setup
    (jl, _), jg = jax.jit(jax.value_and_grad(jlosses.make_vtrace_loss(jbundle), has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, batch))
    loss, grads = _grads(bundle, sd, batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-2)
    want = params_from_jax(bundle.cfg, jax.tree.map(lambda x: np.asarray(x, np.float32), jg))
    cfg32 = bundle.cfg.with_(param_dtype="float32", compute_dtype="float32")
    _, fp32 = _grads(make_model(cfg32), {n: t.float() for n, t in sd.items()}, batch)
    assert set(grads) == set(want) == set(fp32)
    noisy = {}
    for name, g in grads.items():
        assert g.dtype == torch.bfloat16, name
        w = want[name].numpy()
        assert np.abs(w).max() > 0 or name.endswith(".b"), f"{name}: an all-zero leaf"
        if _dist(_np(g), w) <= 5e-2:
            continue
        noisy[name] = (_dist(_np(g), w), _dist(_np(g), _np(fp32[name])),
                       _dist(w, _np(fp32[name])))
        assert noisy[name][1] <= BF16_NOISE, (name, noisy[name])
    assert len(noisy) < len(grads) / 4, noisy


def test_one_train_step_matches_jax(setup):
    """make_train_step (AdamW at lr 1e-3, fp32 moments; qwen3 over two
    micro-batches, their grads summed in fp32) against JAX's jitted step:
    the loss within 1e-2 relative, the params (bf16) within 2 lr plus one
    bf16 ulp of each element, the moments fp32."""
    arch, jbundle, jparams, bundle, sd, batch = setup
    jopt, opt = jadamw(LR), adamw(LR, moment_dtype=torch.float32)
    jstate, jm = jax.jit(jlosses.make_train_step(jbundle, jopt))(
        {"params": jparams, "opt_state": jopt.init(jparams), "step": jnp.zeros((), jnp.int32)},
        jax.tree.map(jnp.asarray, batch))
    state = _port_state(bundle, sd, opt)
    state, metrics = losses.make_train_step(bundle, opt)(state, _to_torch(batch))
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]), rtol=1e-2)
    assert state["step"] == int(jstate["step"]) == 1
    assert all(m.dtype == torch.float32 for m in state["opt_state"]["m"].values())
    jp = params_from_jax(bundle.cfg, jax.tree.map(lambda x: np.asarray(x, np.float32),
                                                  jstate["params"]))
    for name, p in state["params"].named_parameters():
        assert p.dtype == torch.bfloat16, name
        got, want = _np(p), jp[name].numpy()
        ulp = np.spacing(np.abs(want)) * 2.0 ** 16      # bf16 keeps 16 fewer mantissa bits
        assert (np.abs(got - want) <= 2 * LR + ulp).all(), name
