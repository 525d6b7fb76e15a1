"""One V-trace train step at the reference's production dtypes, the port
against the JAX package on the CPU.

The reference's ``production_config`` (``repro.launch.dryrun``) trains
every cell with bf16 params and compute, full remat and AdamW moments in
the published config's ``optimizer_dtype`` (bf16 for deepseek-v3-671b,
fp32 for every other arch); the archs that are not pure data-parallel with
their configs' gradient accumulation, mamba2-2.7b, recurrentgemma-2b,
seamless-m4t-large-v2 and internvl2-1b (pure data-parallel) without. Here:
the smoke configs of all ten LMs with those dtypes (head_dim 16 where they
attend; MLA's q and k of 24 and v of 16, padded to 32), the moment dtype
of the published config (the smoke configs set fp32), the accumulating
archs at ``grad_accum=2``, the same params in both packages (the port's
init in bf16, an MoE's router and router bias fp32 in both, laid out in
the JAX tree by ``test_torch_train``'s ``_params``), the batch JAX drew
(seamless's frames and internvl2's patch embeddings from
``test_torch_train``'s ``_frontend``); and qwen3-14b once more under
remat "dots" in both packages (``DOTS``). The JAX side runs its plain paths
(``attend_ref``, ``ssd_chunked``, the RG-LRU's associative scan) under
``jax.checkpoint``; the port's CPU path is its kernels' plain versions
under ``torch.utils.checkpoint``. On the card the same step runs K1 and
K1-bwd (bf16 at head_dim 16: both on their 3xTF32 kernels), K3 and K3-bwd,
and K4 and K4-bwd (``chip_smoke.py``).

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

The gradient test's JAX side computes its attention as the JAX package's
kernel K1 does (``repro.kernels.flash_attention``: q, k and v in fp32, the
output rounded once), as the port's K1 and its plain version do, where
``attend_ref`` rounds the scores and the softmax's weights to bf16: with
``attend_ref`` as it is, 17 of qwen2.5-32b's 53 leaves (whose qkv biases
give large logits) sit 0.06-0.12 of their max from the fp32 gradient in
JAX, each port leaf within 0.052. And JAX takes the port's bf16 run's ReLU
masks and expert choices, as the port's fp32 run does: a pre-activation
within rounding of 0 (seamless's ReLU MLPs) takes another sign under
another rounding, and a near tie in a router's top-k (the MoE archs)
another expert; either moves its leaf by a token's share, up to 0.42 of
the leaf's max at these sizes, where the same masks and choices in both
packages leave every leaf within 0.1 of the fp32 gradient.
``test_relu_sign_flips_are_bf16_rounding`` holds the port's flips to JAX's
count; the choices that the fp32 run's replay changes are printed (4 of
1280 for qwen3-moe-30b-a3b, 5 of 1120 for deepseek-v3-671b).

Tolerances, against bf16 compute rounding at other places in the two
frameworks (the fp32 tests in ``test_torch_train.py`` hold 1e-4):
- the loss within 1e-2 relative;
- every gradient leaf (bf16, the params' dtype) within 5e-2 of its max of
  JAX's, or, where bf16's rounding noise alone is larger than that, within
  BF16_NOISE of its max of the same gradient taken in fp32 (the port's
  plain path on fp32 params of the same values, which
  ``test_torch_train.py`` holds to JAX's fp32 gradient at 1e-4); fewer
  than a quarter of the leaves may take the fp32 bound (at most 5 of 49,
  qwen3-14b's); a leaf whose gradient is 0 in exact arithmetic
  (``test_torch_train._zero_grad``: seamless's cross-attention key bias)
  within one bf16 ulp (2^-8) of the largest leaf's max, in both packages,
  since its sums cancel to rounding noise; DeepSeek's ``router_bias``,
  which only ranks, exactly 0 in both. At these sizes a leaf is a sum with
  much cancellation, and bf16 compute moves it by 2-9% of its max from
  the fp32 gradient in either package. A wrong mask, cast or gradient path
  moves a leaf by far more;
- the params after one AdamW step within 2 lr plus one bf16 ulp of each
  element, the ulp at the larger of the two packages' values: at step 0
  AdamW moves an element by at most lr, the two steps' updates differ by
  at most 2 lr, and each package's bf16 sum rounds once, by at most half
  an ulp at its own value (where the update takes an element across a
  power of two, e.g. from 5.6e-4 to 2.6e-3, the larger value's ulp is the
  one that binds).
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import make_model as jmake_model  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke_config  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.envs.tokenworld import synthetic_vtrace_batch as jbatch  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.nn import attention as jattention  # noqa: E402
from repro.nn import mlp as jmlp  # noqa: E402
from repro.nn import moe as jmoe  # noqa: E402
from repro.optim.adamw import adamw as jadamw  # noqa: E402
from repro_torch.configs.registry import make_model, smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import losses  # noqa: E402
from repro_torch.device import dtype_of  # noqa: E402
from repro_torch.models.lm import layer_plan  # noqa: E402
from repro_torch.nn.mlp import relu_masks  # noqa: E402
from repro_torch.nn.moe import expert_choices  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from test_torch_train import (_frontend, _np, _params, _port_state, _to_torch,  # noqa: E402
                              _zero_grad)

B, S = 2, 40        # 3 of mamba2's 16-step smoke chunks, ragged
LR = 1e-3
BF16_NOISE = 1e-1   # of a leaf's max: bf16 compute's distance from the fp32 gradient
# XLA rounds every op's result to its type, as PyTorch does (see the module's note)
EXACT = {"xla_allow_excess_precision": False}
# production_config's overrides; the moments take the published config's dtype
PRODUCTION = dict(param_dtype="bfloat16", compute_dtype="bfloat16", remat="full")
# the archs and their overrides: those that are not pure_dp at two
# micro-batches of their config's accumulation; the pure data-parallel ones
# (mamba2, recurrentgemma, seamless, internvl2) at one, as production_config
# sets them
ARCHS = {"qwen3-14b": dict(grad_accum=2), "mamba2-2.7b": {}, "recurrentgemma-2b": {},
         "seamless-m4t-large-v2": {}, "gemma2-9b": dict(grad_accum=2),
         "starcoder2-15b": dict(grad_accum=2), "qwen2.5-32b": dict(grad_accum=2),
         "internvl2-1b": {}, "qwen3-moe-30b-a3b": dict(grad_accum=2),
         "deepseek-v3-671b": dict(grad_accum=2)}


# qwen3-14b's step under remat "dots" (the selective checkpoint) in place of
# production_config's "full", in both packages
DOTS = "qwen3-14b/dots"


@pytest.fixture(scope="module", params=list(ARCHS) + [DOTS])
def setup(request):
    """Both packages' bundles at the production dtypes (DOTS: remat "dots"),
    the same params and the batch JAX drew."""
    arch, _, remat = request.param.partition("/")
    over = dict(PRODUCTION, optimizer_dtype=jget_config(arch).optimizer_dtype, **ARCHS[arch])
    if remat:
        over["remat"] = remat
    jcfg, cfg = jsmoke_config(arch).with_(**over), smoke_config(arch).with_(**over)
    assert cfg == cfg.with_(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    jbundle, bundle = jmake_model(jcfg), make_model(cfg)
    jparams, sd = _params(jbundle, bundle)   # the port's bf16 init, embedding table x 0.1
    assert all(t.dtype == _param_dtype(n) for n, t in sd.items())
    batch = jax.tree.map(np.asarray, jbatch(jax.random.PRNGKey(1), B, S, cfg.vocab_size))
    field = _frontend(cfg, B)
    if field is not None:
        batch["frontend"] = field
    return arch, jbundle, jparams, bundle, sd, batch


def _fp32_leaf(name):
    """An MoE's router and router bias: fp32 in a bf16 model, in both packages."""
    return name.endswith((".router", ".router_bias"))


def _param_dtype(name):
    return torch.float32 if _fp32_leaf(name) else torch.bfloat16


def _k1_attend(monkeypatch):
    """JAX's plain attention (``attend_ref``) as its kernel K1 computes it
    (``repro.kernels.flash_attention``: q, k and v in fp32, the output
    rounded once to q's dtype), as the port's K1 and its plain version do;
    ``attend_ref`` itself rounds the scores and the softmax's weights to
    bf16 on bf16 inputs."""
    real = jattention.attend_ref

    def attend(q, k, v, *args, **kw):
        f32 = [x.astype(jnp.float32) for x in (q, k, v)]
        return real(*f32, *args, **kw).astype(q.dtype)
    for module in (jattention, jencdec):
        monkeypatch.setattr(module, "attend_ref", attend)


def _jax_taking(monkeypatch, cfg, masks, choices):
    """JAX's ReLU MLPs (seamless's) and MoE routers take the port's ReLU
    masks and expert choices, as the port's replays do (``relu_masks``,
    ``expert_choices``): h * mask for relu(h), and the recorded ids in
    place of the router's top-k with its own scores at those ids.
    ``repro.models.encdec.mlp`` and ``repro.nn.moe.route`` are wrapped here,
    and ``ACTS["relu"]`` and ``jax.lax.top_k`` swapped while each traces;
    nothing of the JAX package changes. `masks` and `choices` are the
    port's records in call order: the forward's calls (encoder layers then
    decoder layers; the MoE layers then the MTP block), then the remat
    recompute's. The scanned stacks read a layer's record beside its
    params, under a key "taken". Returns (taken, with_taken): the records
    by where they go, and params -> params with them in place."""
    taken = {}
    if masks:
        mlp, n_enc = jencdec.mlp, cfg.enc_layers

        def masked(p, x, act="silu"):
            with monkeypatch.context() as m:
                m.setitem(jmlp.ACTS, act, lambda h: h * p["taken"].astype(h.dtype))
                return mlp(p, x, act)
        monkeypatch.setattr(jencdec, "mlp", masked)
        fwd = [np.asarray(m_) for m_ in masks[:n_enc + cfg.dec_layers]]
        taken = {"enc/mlp": np.stack(fwd[:n_enc]), "dec/mlp": np.stack(fwd[n_enc:])}
    if choices:
        route = jmoe.route

        def forced(cfg_, p, xf):
            ids = p["taken"]
            with monkeypatch.context() as m:
                m.setattr(jax.lax, "top_k", lambda x, k: (jnp.take_along_axis(x, ids, -1), ids))
                return route(cfg_, p, xf)
        monkeypatch.setattr(jmoe, "route", forced)
        n_moe, period = sum(spec.moe for spec in layer_plan(cfg)), len(cfg.attn_pattern)
        fwd = [np.asarray(c["idx"], np.int32) for c in choices[:n_moe + bool(cfg.mtp_depth)]]
        taken.update({f"main/p{i}/ffn": np.stack(fwd[i:n_moe:period]) for i in range(period)})
        if cfg.mtp_depth:
            taken["mtp/block/ffn"] = fwd[n_moe]

    def put(tree, path, value):
        if not path:
            return dict(tree, taken=value)
        return dict(tree, **{path[0]: put(tree[path[0]], path[1:], value)})

    def with_taken(params, taken):
        for where, value in taken.items():
            params = put(params, where.split("/"), value)
        return params
    return taken, with_taken


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


def test_loss_and_every_gradient_match_jax(setup, monkeypatch):
    """The V-trace loss and every gradient leaf of the whole batch, bf16
    params and compute under full remat, against jax.value_and_grad of the
    same: loss within 1e-2 relative; each leaf within 5e-2 of its max of
    JAX's, or within BF16_NOISE of its max of the fp32 gradient (see the
    module's note), where fewer than a quarter of the leaves may go; a
    leaf that is 0 in exact arithmetic within 2^-8 of the largest leaf's
    max; a router bias exactly 0. JAX's attention computes as K1 does
    (``_k1_attend``); JAX's side and the fp32 run take the bf16 run's ReLU
    masks and expert choices (``_jax_taking``), whose backward recompute
    takes its forward's. JAX rounds every op (``_jax_exact``)."""
    arch, jbundle, jparams, bundle, sd, batch = setup
    cfg = bundle.cfg
    with relu_masks() as masks, expert_choices() as choices:
        loss, grads = _grads(bundle, sd, batch)
    assert bool(masks) == (cfg.act == "relu") and bool(choices) == (cfg.family == "moe")
    # the calls' order: the layers' forward (then an MTP block's), the
    # recompute, last layer first
    n = cfg.enc_layers + cfg.dec_layers
    assert not masks or (len(masks) == 2 * n and all(
        torch.equal(masks[i], masks[-1 - i]) for i in range(n)))
    n = sum(spec.moe for spec in layer_plan(cfg))
    assert not choices or (len(choices) == 2 * n + bool(cfg.mtp_depth) and all(
        torch.equal(choices[i]["idx"], choices[-1 - i]["idx"]) for i in range(n)))
    _k1_attend(monkeypatch)
    taken, with_taken = _jax_taking(monkeypatch, cfg, masks, choices)
    jloss = jlosses.make_vtrace_loss(jbundle)
    (jl, _), jg = _jax_exact(
        jax.value_and_grad(lambda p, t, b: jloss(with_taken(p, t), b), has_aux=True),
        jparams, taken, jax.tree.map(jnp.asarray, batch))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-2)
    want = params_from_jax(cfg, jax.tree.map(lambda x: np.asarray(x, np.float32), jg))
    cfg32 = cfg.with_(param_dtype="float32", compute_dtype="float32")
    with relu_masks(masks), expert_choices(choices) as replayed:
        _, fp32 = _grads(make_model(cfg32), {n: t.float() for n, t in sd.items()}, batch)
    assert set(grads) == set(want) == set(fp32)
    assert replayed["calls"] == len(choices)
    if choices:
        print(f"{arch}: the fp32 run and JAX take the bf16 run's expert choices in its "
              f"{len(choices)} MoE calls; the replay changed {replayed['changed']} of the fp32 "
              f"run's {sum(c['idx'].numel() for c in choices)} (token, k) choices")
    top = max(float(np.abs(w.numpy()).max()) for w in want.values())
    noisy = {}
    for name, g in grads.items():
        assert g.dtype == _param_dtype(name), name
        w = want[name].numpy()
        if name.endswith(".router_bias"):   # ranks only: no gradient in either package
            assert not _np(g).any() and not w.any(), name
            continue
        if _zero_grad(name):
            assert max(float(np.abs(_np(g)).max()), float(np.abs(w).max())) <= 2.0 ** -8 * top, \
                name
            continue
        assert np.abs(w).max() > 0 or name.endswith(".b"), f"{name}: an all-zero leaf"
        if _dist(_np(g), w) <= 5e-2:
            continue
        noisy[name] = (_dist(_np(g), w), _dist(_np(g), _np(fp32[name])))
        assert noisy[name][1] <= BF16_NOISE, (name, noisy[name])
    print(f"{arch}: {len(noisy)} of {len(grads)} leaves farther than 5e-2 of their max from "
          f"JAX's (that distance, and the fp32 gradient's): {noisy}")
    assert len(noisy) < 0.25 * len(grads), noisy


def test_one_train_step_matches_jax(setup):
    """make_train_step (AdamW at lr 1e-3, moments in the published config's
    dtype: bf16 for deepseek, fp32 else; the accumulating archs over two
    micro-batches, their grads summed in fp32) against JAX's jitted step:
    the loss within 1e-2 relative, the params (bf16; an MoE's router fp32)
    within 2 lr plus one bf16 ulp (at the larger of the two values) of each
    element, the moments in that
    dtype in both packages. JAX rounds every op (``_jax_exact``)."""
    arch, jbundle, jparams, bundle, sd, batch = setup
    moments = bundle.cfg.optimizer_dtype
    assert moments == jget_config(arch).optimizer_dtype
    assert moments == ("bfloat16" if arch == "deepseek-v3-671b" else "float32")
    jopt = jadamw(LR, moment_dtype=getattr(jnp, moments))
    opt = adamw(LR, moment_dtype=dtype_of(moments))
    jstate, jm = _jax_exact(
        jlosses.make_train_step(jbundle, jopt),
        {"params": jparams, "opt_state": jopt.init(jparams), "step": jnp.zeros((), jnp.int32)},
        jax.tree.map(jnp.asarray, batch))
    state = _port_state(bundle, sd, opt)
    state, metrics = losses.make_train_step(bundle, opt)(state, _to_torch(batch))
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]), rtol=1e-2)
    assert state["step"] == int(jstate["step"]) == 1
    for kind in ("m", "v"):
        assert all(m.dtype == dtype_of(moments) for m in state["opt_state"][kind].values())
        assert all(m.dtype == jnp.dtype(moments)
                   for m in jax.tree.leaves(jstate["opt_state"][kind]))
    jp = params_from_jax(bundle.cfg, jax.tree.map(lambda x: np.asarray(x, np.float32),
                                                  jstate["params"]))
    for name, p in state["params"].named_parameters():
        assert p.dtype == _param_dtype(name), name
        got, want = _np(p), jp[name].numpy()
        # bf16 keeps 16 fewer mantissa bits; each side rounds at its own value
        ulp = np.spacing(np.maximum(np.abs(got), np.abs(want))) * 2.0 ** 16
        assert (np.abs(got - want) <= 2 * LR + ulp).all(), name


@pytest.mark.parametrize("setup", ["seamless-m4t-large-v2"], indirect=True)
def test_relu_sign_flips_are_bf16_rounding(setup, monkeypatch):
    """The ReLU pre-activations (seamless's MLPs, the forward of the
    loss) whose sign bf16 compute flips from the fp32 run's, in each
    package on the same params and batch: in fp32 the two packages' signs
    agree everywhere; in bf16 the port flips no more of them than JAX
    compiled to round every op (``_jax_exact``), within a quarter, so the
    masks that the gradient test replays in its fp32 run and in JAX hide
    no more flips than bf16 rounding makes in the reference; and the port's bf16
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
