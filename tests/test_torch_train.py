"""The port's V-trace training path against the JAX package, on the CPU.

The same inputs go through both: JAX params converted by
``params_from_jax``, the trajectory batch that JAX's
``synthetic_vtrace_batch`` drew, and numpy grads for the optimizers. The
JAX side runs its plain paths (``attend_ref``, ``ssd_chunked``, the
associative RG-LRU scan), which is what ``jax.value_and_grad``
differentiates; the port's CPU path is its kernels' plain versions under
autograd.

Tolerances, all fp32:
- optimizers, norms, schedules: 1e-6 (one or two roundings apart);
- V-trace returns and losses: 1e-5 (a reverse scan of T steps);
- loss 1e-4 and every gradient leaf within 1e-4 of the leaf's max|g|:
  the forward already differs by up to ~1e-6 from summation order (BLAS
  against XLA dots, a loop against an associative scan) over 4-5 layers,
  and the vocab-wide softmax and the backward add more; a wrong mask,
  gate, norm offset or missing gradient path moves a leaf by far more;
- params after one AdamW step: at step 0 AdamW moves every element by
  lr * g / (|g| + eps), at most lr, so two right implementations may
  differ by up to 2 lr where |g| is near eps; where |g| is at least
  1e-3 of its leaf's max they agree within 1e-3 lr;
- the cross-attention's key bias (seamless's ``xattn.bk``; its keys take no
  rotary embedding) has a gradient of exactly 0: softmax is invariant to
  adding the same q . b_k to every logit of a row. Both packages give
  rounding noise there (1e-11 against a largest leaf of 1e-3), which no
  relative check can compare, so such a leaf and its first moment are
  held to 0 within 1e-6 of the largest leaf's max.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import make_model as jmake_model  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke_config  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.core import vtrace as jvtrace  # noqa: E402
from repro.envs.tokenworld import synthetic_vtrace_batch as jbatch  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.optim.adamw import adamw as jadamw  # noqa: E402
from repro.optim.adamw import apply_updates as japply  # noqa: E402
from repro.optim.adamw import sgd as jsgd  # noqa: E402
from repro.optim import schedule as jschedule  # noqa: E402
from repro.utils.tree import global_norm as jglobal_norm  # noqa: E402
from repro_torch.configs.registry import make_model, smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import losses, vtrace  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.optim import (adamw, apply_updates, cosine_schedule,  # noqa: E402
                               linear_warmup, sgd)
from repro_torch.optim import schedule  # noqa: E402
from repro_torch.utils.tree import global_norm, tree_bytes, tree_size  # noqa: E402

ARCHS = ("qwen3-14b", "mamba2-2.7b", "recurrentgemma-2b", "seamless-m4t-large-v2")
B, S = 2, 40        # S > recurrentgemma's smoke window of 32; 3 of mamba's 16-step chunks
LR = 1e-3


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=tol, rtol=tol)


def _close_leaf(got, want, tol=1e-4):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(_np(got), want, atol=tol * scale, rtol=tol)


def _zero_grad(name):
    """Whether leaf `name`'s gradient is 0 in exact arithmetic: the key bias
    of an attention without a rotary embedding (cross-attention)."""
    return name.endswith(".xattn.bk")


def _close_leaves(got, want):
    """Each leaf within 1e-4 of its max (``_close_leaf``); a leaf whose
    gradient is exactly 0 (``_zero_grad``) within 1e-6 of the largest
    leaf's max of 0, on both sides."""
    top = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for name, g in got.items():
        w = np.asarray(want[name], np.float32)
        if _zero_grad(name):
            assert max(float(np.abs(_np(g)).max()), float(np.abs(w).max())) <= 1e-6 * top, name
        else:
            _close_leaf(g, w)


def _to_torch(batch_np):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch_np.items()}


def _frontend(cfg, b, seed=8):
    """The modality frontend's field (B, F, D) of the smoke config, fp32
    standard normals from numpy (seamless's frames, which its encoder
    reads), or None for a config without one."""
    if not cfg.frontend_tokens:
        return None
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)


def _params(jbundle, bundle):
    """The same params for both packages: the port's init (seed 0), laid
    out in the JAX tree by inverting ``params_from_jax`` (numbering every
    element of the tree that ``jax.eval_shape`` of the JAX init gives, so
    no JAX init runs), with the embedding table scaled by 0.1. The tied
    embeddings of N(0, 1) give recurrentgemma's and mamba2's smoke configs
    logits of std ~9, a one-hot softmax: entropy 0, every importance weight
    0, a loss of ~1e-21 and gradients that test nothing. At 0.1 every term
    of the loss is alive. Returns (JAX params, the port's state dict)."""
    sd = bundle.init(0, device="cpu").state_dict()
    sd["embed.table"].mul_(0.1)
    shapes, tree = jax.tree.flatten(jax.eval_shape(jbundle.init, jax.random.PRNGKey(0)))
    starts = np.cumsum([0] + [int(np.prod(x.shape)) for x in shapes])
    ids = tree.unflatten([np.arange(a, a + int(np.prod(x.shape))).reshape(x.shape)
                          for a, x in zip(starts, shapes)])
    flat = np.full(starts[-1], np.nan, np.float32)
    for name, where in params_from_jax(bundle.cfg, ids).items():
        flat[where.numpy().ravel()] = sd[name].numpy().ravel()
    assert not np.isnan(flat).any()
    leaves = [jnp.asarray(flat[a:a + int(np.prod(x.shape))].reshape(x.shape), x.dtype)
              for a, x in zip(starts, shapes)]
    return tree.unflatten(leaves), sd


# ---------------------------------------------------------------- optimizers

def _tree(rng, n=3):
    return {f"w{i}": rng.standard_normal((5, 7 - i)).astype(np.float32) for i in range(n)}


def test_tree_utils_and_global_norm():
    tree = _tree(np.random.default_rng(0))
    t = {k: torch.from_numpy(v) for k, v in tree.items()}
    _close(global_norm(t), jglobal_norm(jax.tree.map(jnp.asarray, tree)), 1e-6)
    assert tree_size(t) == sum(v.size for v in tree.values())
    assert tree_bytes(t) == 4 * tree_size(t)
    assert global_norm([t["w0"].bfloat16()]).dtype == torch.float32


def test_schedules_match_jax():
    for step in (0, 3, 9, 10, 11, 25, 40, 100):
        for got, want in ((linear_warmup(0.3, 10), jschedule.linear_warmup(0.3, 10)),
                          (cosine_schedule(0.3, 10, 40), jschedule.cosine_schedule(0.3, 10, 40)),
                          (cosine_schedule(1.0, 5, 3, 0.2),
                           jschedule.cosine_schedule(1.0, 5, 3, 0.2))):
            assert isinstance(got(step), float)
            np.testing.assert_allclose(got(step), float(want(jnp.float32(step))), rtol=1e-6)
    assert schedule.linear_warmup is linear_warmup


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight_decay,max_norm", [(0.0, 1.0), (0.1, None), (0.0, 50.0)])
def test_adamw_matches_jax(moment_dtype, weight_decay, max_norm):
    """Three steps on the same numpy grads: updates, moments and grad_norm;
    clipping to norm 1 (the default) and none; bias correction on step+1."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    jopt = jadamw(jschedule.cosine_schedule(1e-2, 2, 10), weight_decay=weight_decay,
                            max_grad_norm=max_norm, moment_dtype=jnp.dtype(moment_dtype))
    opt = adamw(cosine_schedule(1e-2, 2, 10), weight_decay=weight_decay, max_grad_norm=max_norm,
                moment_dtype=getattr(torch, moment_dtype))
    jp = jax.tree.map(jnp.asarray, params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), opt.init(tp)
    for step in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) * 3 for k, v in params.items()}
        ju, js, jm = jopt.update(jax.tree.map(jnp.asarray, grads), js, jp, jnp.int32(step))
        jp = japply(jp, ju)
        tu, ts, tm = opt.update({k: torch.from_numpy(v) for k, v in grads.items()}, ts, tp, step)
        tp = apply_updates(tp, tu)
        _close(tm["grad_norm"], jm["grad_norm"], 1e-6)
        tol = 1e-6 if moment_dtype == "float32" else 1e-2   # bf16 moments round alike
        for k in params:
            _close(tu[k], ju[k], 1e-6 if moment_dtype == "float32" else 1e-4)
            _close(tp[k], jp[k], 1e-6)
            _close(ts["m"][k], js["m"][k], tol)
            _close(ts["v"][k], js["v"][k], tol)
            assert ts["m"][k].dtype == getattr(torch, moment_dtype)


@pytest.mark.parametrize("momentum,max_norm", [(0.0, None), (0.9, 1.0)])
def test_sgd_matches_jax(momentum, max_norm):
    rng = np.random.default_rng(2)
    params = _tree(rng)
    jopt = jsgd(0.05, momentum=momentum, max_grad_norm=max_norm)
    opt = sgd(0.05, momentum=momentum, max_grad_norm=max_norm)
    jp = jax.tree.map(jnp.asarray, params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), opt.init(tp)
    for step in range(2):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        ju, js, jm = jopt.update(jax.tree.map(jnp.asarray, grads), js, jp, jnp.int32(step))
        jp = japply(jp, ju)
        tu, ts, tm = opt.update({k: torch.from_numpy(v) for k, v in grads.items()}, ts, tp, step)
        tp = apply_updates(tp, tu)
        _close(tm["grad_norm"], jm["grad_norm"], 1e-6)
        for k in params:
            _close(tp[k], jp[k], 1e-6)


# ------------------------------------------------------------------ V-trace

def test_vtrace_and_losses_match_jax():
    rng = np.random.default_rng(3)
    b, t = 3, 17
    f = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    tlp, blp = -np.abs(f(b, t)), -np.abs(f(b, t))
    rew, vals, boot, ent = f(b, t) * 0.1, f(b, t), f(b), np.abs(f(b, t))
    disc = np.where(rng.random((b, t)) < 0.1, 0.0, 0.99).astype(np.float32)
    mask = (rng.random((b, t)) < 0.8).astype(np.float32)
    for kw in ({}, {"rho_bar": 0.5, "c_bar": 0.9}):
        jr = jvtrace.vtrace(*map(jnp.asarray, (tlp, blp, rew, disc, vals, boot)), **kw)
        tr = vtrace.vtrace(*map(torch.from_numpy, (tlp, blp, rew, disc, vals, boot)), **kw)
        for name in ("vs", "pg_advantages", "rhos"):
            _close(getattr(tr, name), getattr(jr, name), 1e-5)
        jl = jvtrace.vtrace_losses(jnp.asarray(tlp), jnp.asarray(ent), jr, jnp.asarray(vals),
                                   jnp.asarray(mask))
        tl = vtrace.vtrace_losses(torch.from_numpy(tlp), torch.from_numpy(ent), tr,
                                  torch.from_numpy(vals), torch.from_numpy(mask))
        for g, w in zip(tl, jl):
            _close(g, w, 1e-5)
    # vs and the advantages are targets: no gradient flows through them
    v = torch.from_numpy(vals).requires_grad_()
    tr = vtrace.vtrace(*map(torch.from_numpy, (tlp, blp, rew, disc)), v, torch.from_numpy(boot))
    assert tr.vs.grad_fn is None and tr.pg_advantages.grad_fn is None


# ------------------------------------------ the loss, its gradients, a step

@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    """JAX and port bundles, the same params, and the batch JAX drew (with
    the frontend's field where the config has one: seamless's 8 frames)."""
    arch = request.param
    jcfg, cfg = jsmoke_config(arch), smoke_config(arch)
    assert cfg == cfg.with_(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    jbundle, bundle = jmake_model(jcfg), make_model(cfg)
    jparams, sd = _params(jbundle, bundle)
    batch = jax.tree.map(np.asarray, jbatch(jax.random.PRNGKey(1), B, S, cfg.vocab_size))
    field = _frontend(cfg, B)
    if field is not None:
        batch["frontend"] = field
    return arch, jbundle, jparams, bundle, sd, batch


def _port_state(bundle, sd, opt):
    state = losses.init_train_state(bundle, opt, seed=0, device="cpu")
    state["params"].load_state_dict(sd)
    return state


def test_vtrace_loss_and_every_gradient_match_jax(setup):
    arch, jbundle, jparams, bundle, sd, batch = setup
    jloss = jlosses.make_vtrace_loss(jbundle)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, batch))
    state = _port_state(bundle, sd, adamw(LR))
    params = state["params"]
    loss, metrics = losses.make_vtrace_loss(bundle)(params, _to_torch(batch))
    _close(loss, jl, 1e-4)
    for k in ("pg_loss", "value_loss", "entropy_loss"):
        _close(metrics[k], jm[k], 1e-4)
    named = dict(params.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    want = params_from_jax(bundle.cfg, jax.tree.map(np.asarray, jg))
    assert set(grads) == set(want)
    _close_leaves(grads, {n: w.numpy() for n, w in want.items()})
    assert all(float(want[n].abs().max()) > 0 for n in want if not n.endswith(".b")), \
        "a gradient leaf is all zeros: the check would not see a missing path"


def test_vtrace_loss_with_a_frontend_matches_jax():
    """internvl2-1b's reduced config with its modality frontend (8 patch
    embeddings of 24 before the tokens): the model's outputs hold 8 more
    positions than the batch has tokens, and the loss reads logits and
    values from position 8 on, as the reference's. The frontend field is
    drawn with numpy from a seed, rounded to bf16 alike in both packages
    and fed to both. Loss, metrics and every gradient leaf within 1e-4 of
    each one's max."""
    arch, b, s = "internvl2-1b", 2, 8
    jcfg, cfg = jsmoke_config(arch), smoke_config(arch)
    jbundle, bundle = jmake_model(jcfg), make_model(cfg)
    jparams, sd = _params(jbundle, bundle)
    batch = jax.tree.map(np.asarray, jbatch(jax.random.PRNGKey(1), b, s, cfg.vocab_size))
    field = np.random.default_rng(8).standard_normal(
        (b, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    jb = dict(jax.tree.map(jnp.asarray, batch), frontend=jnp.asarray(field).astype(jnp.bfloat16))
    tb = dict(_to_torch(batch), frontend=torch.from_numpy(field).bfloat16())
    (jl, jm), jg = jax.jit(jax.value_and_grad(jlosses.make_vtrace_loss(jbundle), has_aux=True))(
        jparams, jb)
    params = _port_state(bundle, sd, adamw(LR))["params"]
    loss, metrics = losses.make_vtrace_loss(bundle)(params, tb)
    _close_leaf(loss, jl)
    assert set(metrics) == set(jm)
    for k in jm:
        _close_leaf(metrics[k], jm[k])
    named = dict(params.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jg))
    assert set(grads) == set(want) and "frontend.w" in grads
    for name, g in grads.items():
        _close_leaf(g, want[name].numpy())
    assert float(want["frontend.w"].abs().max()) > 0
    # the launcher's batches carry the field, (B, F, D) bf16
    run = __import__("repro_torch.launch.train", fromlist=["setup"]).setup(
        arch, smoke=True, batch=b, seq=s, device="cpu")
    got = run.batch_at(0)["frontend"]
    assert got.shape == (b, cfg.frontend_tokens, cfg.frontend_dim) and got.dtype == torch.bfloat16


def _check_step(bundle, jstate, jm, state, metrics):
    """Loss, grad_norm, params and moments after one step, held to JAX's."""
    _close(metrics["loss"], jm["loss"], 1e-4)
    _close(metrics["grad_norm"], jm["grad_norm"], 1e-4)
    assert state["step"] == int(jstate["step"]) == 1
    cvt = lambda t: params_from_jax(bundle.cfg, jax.tree.map(np.asarray, t))   # noqa: E731
    jp, jmom = cvt(jstate["params"]), cvt(jstate["opt_state"]["m"])
    _close_leaves(state["opt_state"]["m"], {n: m.numpy() for n, m in jmom.items()})
    for name, p in state["params"].named_parameters():
        got, want = _np(p), jp[name].numpy()
        m = jmom[name].numpy()            # (1 - b1) * clipped g at step 0
        settled = np.abs(m) >= 1e-3 * max(float(np.abs(m).max()), 1e-30)
        diff = np.abs(got - want)
        assert diff.max() <= 2 * LR + 1e-6, name
        assert diff[settled].max(initial=0.0) <= 1e-3 * LR + 1e-6, name


def test_one_train_step_matches_jax(setup):
    """make_train_step (AdamW at lr 1e-3) against JAX's jitted step."""
    arch, jbundle, jparams, bundle, sd, batch = setup
    jopt, opt = jadamw(LR), adamw(LR)
    jstep = jax.jit(jlosses.make_train_step(jbundle, jopt))
    jstate, jm = jstep({"params": jparams, "opt_state": jopt.init(jparams),
                        "step": jnp.zeros((), jnp.int32)}, jax.tree.map(jnp.asarray, batch))
    state = _port_state(bundle, sd, opt)
    state, metrics = losses.make_train_step(bundle, opt)(state, _to_torch(batch))
    _check_step(bundle, jstate, jm, state, metrics)


def test_grad_accum_matches_jax_scan():
    """grad_accum=2 (two micro-batches of 1, grads summed in fp32) against
    JAX's scan over micro-batches, on mamba2 (the path is the same for every
    family; mamba2's JAX step compiles fastest)."""
    arch = "mamba2-2.7b"
    jcfg, cfg = jsmoke_config(arch).with_(grad_accum=2), smoke_config(arch).with_(grad_accum=2)
    jbundle, bundle = jmake_model(jcfg), make_model(cfg)
    jparams, sd = _params(jbundle, bundle)
    batch = jax.tree.map(np.asarray, jbatch(jax.random.PRNGKey(1), B, S, cfg.vocab_size))
    jopt, opt = jadamw(LR), adamw(LR)
    jstate, jm = jax.jit(jlosses.make_train_step(jbundle, jopt))(
        {"params": jparams, "opt_state": jopt.init(jparams), "step": jnp.zeros((), jnp.int32)},
        jax.tree.map(jnp.asarray, batch))
    state = _port_state(bundle, sd, opt)
    state, metrics = losses.make_train_step(bundle, opt)(state, _to_torch(batch))
    _check_step(bundle, jstate, jm, state, metrics)
    for k in ("pg_loss", "value_loss", "entropy_loss"):
        _close(metrics[k], jm[k], 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_full_matches_none(arch):
    """Per-layer activation checkpointing recomputes the same layers: loss
    and every gradient agree with remat "none" to rounding (1e-6)."""
    cfg = smoke_config(arch)
    gen = torch.Generator().manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, 24), generator=gen),
             "rewards": torch.randn(B, 24, generator=gen) * 0.1,
             "discounts": torch.full((B, 24), 0.99),
             "behavior_logprobs": -torch.randn(B, 24, generator=gen).abs(),
             "mask": torch.ones(B, 24)}
    field = _frontend(cfg, B)
    if field is not None:
        batch["frontend"] = torch.from_numpy(field)
    out = {}
    for remat in ("none", "full"):
        bundle = make_model(cfg.with_(remat=remat))
        params = bundle.init(0, device="cpu").requires_grad_(True)
        with torch.no_grad():
            params.embed.table.mul_(0.1)      # see _jparams
        loss, _ = losses.make_vtrace_loss(bundle)(params, batch)
        out[remat] = (loss, torch.autograd.grad(loss, list(params.parameters())))
    _close(out["full"][0], _np(out["none"][0]), 1e-6)
    for g, w in zip(out["full"][1], out["none"][1]):
        _close_leaf(g, _np(w), 1e-6)
    with pytest.raises(NotImplementedError, match="dots"):
        make_model(cfg.with_(remat="dots")).forward(
            make_model(cfg).init(0, device="cpu").requires_grad_(True), batch)


def test_token_logprobs_entropy_matches_jax():
    """gather in place of the reference's one-hot contraction: same values."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 6, 11)).astype(np.float32) * 3
    acts = rng.integers(0, 11, (2, 6))
    want = jlosses._token_logprobs_entropy(jnp.asarray(logits), jnp.asarray(acts))
    got = losses._token_logprobs_entropy(torch.from_numpy(logits), torch.from_numpy(acts))
    for g, w in zip(got, want):
        _close(g, w, 1e-6)


# ------------------------------------------- the backward kernels' plain versions

def _attn_inputs(rng, b, s, h, kh, d):
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)   # noqa: E731
    return f(b, s, h, d), f(b, s, kh, d), f(b, s, kh, d), f(b, s, h, d)


@pytest.mark.parametrize("h,kh,d,kw", [
    (4, 2, 16, {}),                               # GQA 2:1, causal
    (10, 1, 256, {"window": 8}),                  # GQA 10:1 at D 256, window < S
    (4, 4, 16, {"softcap": 2.0}),                 # softcap, expanded kv
    (4, 2, 16, {"causal": False, "window": 5}),
])
def test_flash_attention_bwd_plain(h, kh, d, kw):
    """K1-bwd's plain version (the formulas the kernel computes) against
    autograd of the port's plain forward and jax.vjp of attention_ref with
    k, v expanded over each kv head's query heads; 1e-5 of max|g|."""
    b, s = 2, 20
    kw = {"causal": True, **kw}
    q, k, v, do = _attn_inputs(np.random.default_rng(6), b, s, h, kh, d)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = ops.flash_attention_plain(tq, tk, tv, **kw)
    auto = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    lse = ops.flash_attention_lse_plain(tq.detach(), tk.detach(), **kw)
    plain = ops.flash_attention_bwd_plain(tq.detach(), tk.detach(), tv.detach(), o.detach(),
                                          lse, torch.from_numpy(do), **kw)

    def jattn(q, k, v):                     # (B,S,H,D) through the (BH,S,D) oracle
        fold = lambda x: jnp.repeat(x, h // x.shape[2], 2).transpose(0, 2, 1, 3).reshape(
            b * h, s, d)                    # noqa: E731
        out = jref.attention_ref(fold(q), fold(k), fold(v), **kw)
        return out.reshape(b, h, s, d).transpose(0, 2, 1, 3)
    jo, vjp = jax.vjp(jattn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _close(o, jo, 1e-5)
    for p, a, j in zip(plain, auto, vjp(jnp.asarray(do))):
        _close_leaf(p, _np(a), 1e-5)
        _close_leaf(p, j, 1e-5)


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_bwd_plain(with_h0):
    """K4-bwd's plain version (the reverse recurrence) against autograd of
    the plain scan and jax.vjp of rglru_ref, dy and dh_last both nonzero."""
    rng = np.random.default_rng(7)
    b, s, w = 2, 19, 5
    a = (1 / (1 + np.exp(-rng.standard_normal((b, s, w)) - 2))).astype(np.float32)
    bb = rng.standard_normal((b, s, w)).astype(np.float32) * 0.1
    h0 = rng.standard_normal((b, w)).astype(np.float32) if with_h0 else None
    dy = rng.standard_normal((b, s, w)).astype(np.float32)
    dh = rng.standard_normal((b, w)).astype(np.float32)
    ta, tb = torch.from_numpy(a).requires_grad_(), torch.from_numpy(bb).requires_grad_()
    th0 = None if h0 is None else torch.from_numpy(h0).requires_grad_()
    y, hl = ops.rglru_scan_plain(ta, tb, h0=th0)
    ins = (ta, tb) + (() if h0 is None else (th0,))
    auto = torch.autograd.grad((y * torch.from_numpy(dy)).sum()
                               + (hl * torch.from_numpy(dh)).sum(), ins)
    plain = ops.rglru_scan_bwd_plain(ta.detach(), y.detach(), None if h0 is None else th0.detach(),
                                     torch.from_numpy(dy), torch.from_numpy(dh))
    assert (plain[2] is None) == (h0 is None)
    jins = (jnp.asarray(a), jnp.asarray(bb)) + (() if h0 is None else (jnp.asarray(h0),))
    (jy, jh), vjp = jax.vjp(lambda *x: jref.rglru_ref(*x), *jins)
    jgrads = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    for p, a_, j in zip([g for g in plain if g is not None], auto, jgrads):
        _close_leaf(p, _np(a_), 1e-5)
        _close_leaf(p, j, 1e-5)


def test_grad_guard_predicate():
    """The guard that makes K1's bf16 route, K2 and K3 raise on the card
    under autograd: grad mode on and some input requiring a gradient. On
    the CPU the plain versions run and carry a grad_fn."""
    x = torch.zeros(2, requires_grad=True)
    y = torch.zeros(2)
    assert ops.needs_grad(y, x) and ops.needs_grad(None, x)
    assert not ops.needs_grad(y, None)
    with torch.no_grad():
        assert not ops.needs_grad(x)
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    assert ops.flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16()).grad_fn is not None
    assert ops.decode_attention(q[:, 0], q, q, torch.full((1,), 3)).grad_fn is not None
