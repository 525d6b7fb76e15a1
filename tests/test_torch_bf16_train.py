"""One V-trace train step at the reference's production dtypes, the port
against the JAX package on the CPU.

The reference's ``production_config`` (``repro.launch.dryrun``) trains
every cell with bf16 params and compute, full remat and fp32 AdamW
moments; qwen3-14b and gemma2-9b with their configs' gradient
accumulation, mamba2-2.7b, recurrentgemma-2b and seamless-m4t-large-v2
(pure data-parallel) without. Here: the smoke configs of all five with
those dtypes (head_dim 16 where they attend), qwen3's and gemma2's at
``grad_accum=2``, the same params in both packages (the port's init in
bf16, laid out in the JAX tree by ``test_torch_train``'s ``_params``), the
batch JAX drew (seamless's frames from ``test_torch_train``'s
``_frontend``). The JAX side runs its plain paths (``attend_ref``,
``ssd_chunked``, the RG-LRU's associative scan) under ``jax.checkpoint``;
the port's CPU path is its kernels' plain versions under
``torch.utils.checkpoint``. On the card the same step runs K1 and K1-bwd
(bf16 at head_dim 16: both on their 3xTF32 kernels), K3 and K3-bwd, and
K4 and K4-bwd (``chip_smoke.py``).

JAX's side is compiled with XLA's ``xla_allow_excess_precision`` off
(``_jax_exact``), so that it rounds every bf16 op's result as PyTorch does
on the CPU and on the card. By default XLA's CPU compile carries fp32
across some bf16 casts inside its fusions: a more precise bf16 than
either framework's eager one. At seamless's smoke step that default flips
the sign of 25 ReLU pre-activations from their fp32 sign, the port 41 and
JAX rounding every op 38; its bf16 leaves then sit up to 0.12 of their max
from the fp32 gradient against the port's 0.35 and the rounding JAX's
0.34, and 42 of the 85 leaves with a gradient part from the port's by
more than 5e-2 against 8 (``test_relu_sign_flips_are_bf16_rounding``
prints these; run it with ``-s``).

Tolerances, against bf16 compute rounding at other places in the two
frameworks (the fp32 tests in ``test_torch_train.py`` hold 1e-4):
- the loss within 1e-2 relative;
- every gradient leaf (bf16, the params' dtype) within 5e-2 of its max of
  JAX's, or, where bf16's rounding noise alone is larger than that, within
  BF16_NOISE of its max of the same gradient taken in fp32 (the port's
  plain path on fp32 params of the same values, which
  ``test_torch_train.py`` holds to JAX's fp32 gradient at 1e-4), the fp32
  run replaying the bf16 run's ReLU masks (``repro_torch.nn.mlp.relu_masks``:
  seamless's ReLU MLPs; at 80 tokens a pre-activation whose sign bf16
  rounding flips moves its leaf by one token's share, up to 0.35 of the
  leaf's max, where with the masks replayed every leaf sits within 0.03;
  the flips the replay hides are held to JAX's count by
  ``test_relu_sign_flips_are_bf16_rounding``); a leaf whose gradient is 0
  in exact arithmetic (``test_torch_train._zero_grad``: seamless's
  cross-attention key bias) within one bf16 ulp (2^-8) of the largest
  leaf's max, in both packages, since its sums cancel to rounding noise.
  At these sizes a leaf is a sum with much cancellation, and bf16 compute
  moves it by 2-9% of its max from the fp32 gradient in either package
  (seamless's sign flips aside), and the two packages' leaves differ by
  more than 5e-2 on a few leaves whichever package is nearer to fp32. A wrong mask, cast or gradient
  path moves a leaf by far more. Fewer than a quarter of the leaves may
  take the fp32 bound;
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
from repro.nn import mlp as jmlp  # noqa: E402
from repro.optim.adamw import adamw as jadamw  # noqa: E402
from repro_torch.configs.registry import make_model, smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import losses  # noqa: E402
from repro_torch.nn.mlp import relu_masks  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from test_torch_train import (_frontend, _np, _params, _port_state, _to_torch,  # noqa: E402
                              _zero_grad)

B, S = 2, 40        # 3 of mamba2's 16-step smoke chunks, ragged
LR = 1e-3
BF16_NOISE = 1e-1   # of a leaf's max: bf16 compute's distance from the fp32 gradient
# XLA rounds every op's result to its type, as PyTorch does (see the module's note)
EXACT = {"xla_allow_excess_precision": False}
PRODUCTION = dict(param_dtype="bfloat16", compute_dtype="bfloat16", remat="full",
                  optimizer_dtype="float32")
# the archs and their overrides: qwen3-14b and gemma2-9b (not pure_dp) at two
# micro-batches of their config's accumulation; the pure data-parallel ones
# (mamba2, recurrentgemma, seamless) at one, as production_config sets them
ARCHS = {"qwen3-14b": dict(grad_accum=2), "mamba2-2.7b": {}, "recurrentgemma-2b": {},
         "seamless-m4t-large-v2": {}, "gemma2-9b": dict(grad_accum=2)}


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
    field = _frontend(cfg, B)
    if field is not None:
        batch["frontend"] = field
    return arch, jbundle, jparams, bundle, sd, batch


def _jax_exact(fn, *args):
    """fn(*args) jitted and compiled with EXACT."""
    return jax.jit(fn).lower(*args).compile(EXACT)(*args)


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
    module's note, with the bf16 run's ReLU masks), where fewer than a
    quarter of the leaves may go; a leaf that is 0 in exact arithmetic
    within 2^-8 of the largest leaf's max. JAX rounds every op
    (``_jax_exact``)."""
    arch, jbundle, jparams, bundle, sd, batch = setup
    (jl, _), jg = _jax_exact(jax.value_and_grad(jlosses.make_vtrace_loss(jbundle), has_aux=True),
                             jparams, jax.tree.map(jnp.asarray, batch))
    with relu_masks() as masks:
        loss, grads = _grads(bundle, sd, batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-2)
    want = params_from_jax(bundle.cfg, jax.tree.map(lambda x: np.asarray(x, np.float32), jg))
    cfg32 = bundle.cfg.with_(param_dtype="float32", compute_dtype="float32")
    with relu_masks(masks):
        _, fp32 = _grads(make_model(cfg32), {n: t.float() for n, t in sd.items()}, batch)
    assert set(grads) == set(want) == set(fp32)
    assert bool(masks) == (bundle.cfg.act == "relu")
    top = max(float(np.abs(w.numpy()).max()) for w in want.values())
    noisy = {}
    for name, g in grads.items():
        assert g.dtype == torch.bfloat16, name
        w = want[name].numpy()
        if _zero_grad(name):
            assert max(float(np.abs(_np(g)).max()), float(np.abs(w).max())) <= 2.0 ** -8 * top, \
                name
            continue
        assert np.abs(w).max() > 0 or name.endswith(".b"), f"{name}: an all-zero leaf"
        if _dist(_np(g), w) <= 5e-2:
            continue
        noisy[name] = (_dist(_np(g), w), _dist(_np(g), _np(fp32[name])),
                       _dist(w, _np(fp32[name])))
        assert noisy[name][1] <= BF16_NOISE, (name, noisy[name])
    assert len(noisy) < 0.25 * len(grads), noisy


def test_one_train_step_matches_jax(setup):
    """make_train_step (AdamW at lr 1e-3, fp32 moments; qwen3 over two
    micro-batches, their grads summed in fp32) against JAX's jitted step:
    the loss within 1e-2 relative, the params (bf16) within 2 lr plus one
    bf16 ulp of each element, the moments fp32. JAX rounds every op
    (``_jax_exact``)."""
    arch, jbundle, jparams, bundle, sd, batch = setup
    jopt, opt = jadamw(LR), adamw(LR, moment_dtype=torch.float32)
    jstate, jm = _jax_exact(
        jlosses.make_train_step(jbundle, jopt),
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


@pytest.mark.parametrize("setup", ["seamless-m4t-large-v2"], indirect=True)
def test_relu_sign_flips_are_bf16_rounding(setup, monkeypatch):
    """The ReLU pre-activations (seamless's MLPs, the forward of the
    loss) whose sign bf16 compute flips from the fp32 run's, in each
    package on the same params and batch: in fp32 the two packages' signs
    agree everywhere; in bf16 the port flips no more of them than JAX
    compiled to round every op (``_jax_exact``), within a quarter, so the
    masks that the gradient test's fp32 run replays hide no more flips
    than bf16 rounding makes in the reference; and the port's bf16
    gradient, without replayed masks, sits no farther from the fp32
    gradient than that JAX's does, within a quarter (the farthest leaf,
    over its max). JAX's default compile (excess precision) flips fewer
    and sits nearer; its numbers are printed, not held."""
    _, jbundle, jparams, bundle, sd, batch = setup
    cfg = bundle.cfg
    jmasks = []

    def jrelu(h):
        jax.debug.callback(lambda x: jmasks.append(np.asarray(x) > 0), h, ordered=True)
        return jax.nn.relu(h)
    monkeypatch.setitem(jmlp.ACTS, "relu", jrelu)

    def jax_signs(dtype, options):
        over = dict(param_dtype=dtype, compute_dtype=dtype)
        fn = jlosses.make_vtrace_loss(jmake_model(jbundle.cfg.with_(**over)))
        args = (jax.tree.map(lambda x: x.astype(dtype), jparams),
                jax.tree.map(jnp.asarray, batch))
        jmasks.clear()
        jax.block_until_ready(jax.jit(fn).lower(*args).compile(options)(*args))
        return list(jmasks)

    def port_signs(dtype):
        b = make_model(cfg.with_(param_dtype=dtype, compute_dtype=dtype))
        params = _port_state(b, {n: t.to(getattr(torch, dtype)) for n, t in sd.items()},
                             adamw(LR))["params"]
        with torch.no_grad(), relu_masks() as masks:
            losses.make_vtrace_loss(b)(params, _to_torch(batch))
        return [m.numpy() for m in masks]

    def flips(a, b):
        assert len(a) == len(b) == cfg.enc_layers + cfg.dec_layers
        return sum(int((x != y).sum()) for x, y in zip(a, b))

    j32, p32 = jax_signs("float32", EXACT), port_signs("float32")
    assert flips(j32, p32) == 0
    port = flips(port_signs("bfloat16"), p32)
    exact = flips(jax_signs("bfloat16", EXACT), j32)
    default = flips(jax_signs("bfloat16", None), j32)
    monkeypatch.setitem(jmlp.ACTS, "relu", jax.nn.relu)

    _, grads = _grads(bundle, sd, batch)
    cfg32 = cfg.with_(param_dtype="float32", compute_dtype="float32")
    _, fp32 = _grads(make_model(cfg32), {n: t.float() for n, t in sd.items()}, batch)
    vg = jax.value_and_grad(jlosses.make_vtrace_loss(jbundle), has_aux=True)
    args = (jparams, jax.tree.map(jnp.asarray, batch))
    names = [n for n in grads if not _zero_grad(n)]
    far, parting = {}, {}
    for kind, options in (("exact", EXACT), ("default", None)):
        jg = jax.jit(vg).lower(*args).compile(options)(*args)[1]
        want = params_from_jax(cfg, jax.tree.map(lambda x: np.asarray(x, np.float32), jg))
        far[kind] = max(_dist(want[n].numpy(), _np(fp32[n])) for n in names)
        parting[kind] = sum(_dist(_np(grads[n]), want[n].numpy()) > 5e-2 for n in names)
    far["port"] = max(_dist(_np(grads[n]), _np(fp32[n])) for n in names)
    print(f"ReLU sign flips from fp32 of {sum(m.size for m in p32)} pre-activations: port "
          f"{port}, JAX rounding every op {exact}, JAX's default compile {default}; the "
          f"farthest of {len(names)} bf16 leaves from the fp32 gradient, over its max: port "
          f"{far['port']:.3f}, JAX rounding every op {far['exact']:.3f}, JAX's default compile "
          f"{far['default']:.3f}; leaves of the port farther than 5e-2 from JAX's: "
          f"{parting['exact']} and {parting['default']}")
    assert 0 < port <= 1.25 * exact
    assert far["port"] <= 1.25 * far["exact"]
