"""The port's MoE, MLA and MTP against the JAX package, on the CPU in fp32:
``nn/moe.py``'s route and capacity dispatch, ``nn/mla.py``'s naive prefill
(through K1's plain version on the padded inputs) and absorbed decode, and
the reduced configs of qwen3-moe-30b-a3b and deepseek-v3-671b (forward with
the router loss and the MTP logits, prefill, decode, greedy tokens, the
V-trace loss with its router and MTP terms) on params converted by
``params_from_jax``, with inputs drawn from numpy seeds.

Tolerance 1e-4 (absolute and relative), as in tests/test_torch_dense.py:
both sides compute in fp32, so what differs is the order of summation. The
routing itself is compared exactly (expert ids and dropped pairs): a near
tie flipped by rounding would show as a mismatch, not hide in a tolerance.
The reduced configs' capacity factor is the reference's 8.0 (no drops);
each test that matters for drops runs at 1.25 too and checks that the
seed really drops (token, k) pairs there.
"""

import contextlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import make_model as jmake_model  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke_config  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.envs.tokenworld import synthetic_vtrace_batch as jbatch  # noqa: E402
from repro.launch.serve import greedy_generate as jgreedy  # noqa: E402
from repro.nn import mla as jmla  # noqa: E402
from repro.nn import moe as jmoe  # noqa: E402
from repro.sharding.param import ArrayMaker  # noqa: E402
from repro_torch.configs.registry import get_config, make_model, smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import losses  # noqa: E402
from repro_torch.launch.serve import greedy_generate  # noqa: E402
from repro_torch.models.lm import check_supported, layer_plan  # noqa: E402
from repro_torch.nn import mla, moe  # noqa: E402

TOL = 1e-4
ARCHS = ("qwen3-moe-30b-a3b", "deepseek-v3-671b")
B, S, MAX_LEN, STEPS = 2, 12, 32, 6


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=tol, rtol=tol)


def _load(module, jparams):
    """A port module's params from a JAX param dict with the same names."""
    flat = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[f"{prefix}{k}"] = torch.from_numpy(np.array(v))
    walk(jparams)
    module.load_state_dict(flat)
    return module


def _drops(idx, cfg, n):
    """(token, k) pairs past capacity, counted from the expert ids alone: an
    expert keeps its first `cap` pairs in the stable order."""
    counts = np.bincount(np.asarray(idx).ravel(), minlength=cfg.num_experts)
    return int(np.maximum(counts - moe.capacity(cfg, n), 0).sum())


@contextlib.contextmanager
def _routes():
    """Yield a list that gets each ``moe`` call's (expert ids, capacity, dropped
    pairs) made inside the block (``moe.route`` wrapped)."""
    calls, real = [], moe.route

    def route(cfg, p, xf):
        gates, idx, aux = real(cfg, p, xf)
        calls.append({"idx": idx, "cap": moe.capacity(cfg, xf.shape[0]),
                      "dropped": _drops(idx, cfg, xf.shape[0])})
        return gates, idx, aux
    moe.route = route
    try:
        yield calls
    finally:
        moe.route = real


# ------------------------------------------------------------------ MoE layer

def _moe_cfg(score, shared, cf, **kw):
    base = smoke_config("deepseek-v3-671b" if score == "sigmoid" else "qwen3-moe-30b-a3b")
    return base.with_(router_score=score, n_shared_experts=shared, capacity_factor=cf, **kw)


def _jmoe(cfg, jp, x):
    return jax.jit(lambda p_, x_: jmoe.moe(cfg, p_, x_))(jp, jnp.asarray(x))


def _moe_pair(cfg, seed=0):
    jp = jmoe.init_moe(ArrayMaker(jax.random.PRNGKey(seed)), cfg)
    return jp, _load(moe.MoE(cfg), jp)


@pytest.mark.parametrize("cf", [8.0, 1.25])
@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("score", ["softmax", "sigmoid"])
def test_route_and_moe_match_jax(score, shared, cf):
    """route's gates, expert ids and aux loss, then moe's output, at the
    reference's smoke capacity (8.0) and at 1.25, where this seed drops."""
    cfg = _moe_cfg(score, shared, cf)
    jp, p = _moe_pair(cfg)
    if score == "sigmoid":   # a live bias: it ranks, it does not weigh
        bias = np.linspace(-0.5, 0.5, cfg.num_experts).astype(np.float32)
        jp["router_bias"] = jnp.asarray(bias)
        p.router_bias.copy_(torch.from_numpy(bias))
    x = np.random.default_rng(1).standard_normal((3, 20, cfg.d_model)).astype(np.float32)
    xf = x.reshape(-1, cfg.d_model)
    jg, jidx, jaux = jax.jit(lambda p_, x_: jmoe.route(cfg, p_, x_))(jp, jnp.asarray(xf))
    g, idx, aux = moe.route(cfg, p, torch.from_numpy(xf))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(g, jg)
    _close(aux, jaux)
    jy, jaux2 = _jmoe(cfg, jp, x)
    with _routes() as rec:
        y, aux2 = moe.moe(cfg, p, torch.from_numpy(x))
    _close(y, jy)
    _close(aux2, jaux2)
    assert aux2.dtype == torch.float32 and aux2.dim() == 0
    np.testing.assert_array_equal(rec[0]["idx"].numpy(), np.asarray(jidx))
    want = _drops(jidx, cfg, xf.shape[0])
    assert (want > 0) == (cf < 2), f"capacity {cf}: {want} pairs dropped"


def test_decode_batch_cap_one_collision():
    """A decode-sized call: 4 tokens, 16 experts, top 2, capacity 1.25: cap
    is ceil(4 * 2 / 16 * 1.25) = 1. Tokens 1 and 3 equal token 0, so all
    three pick the same two experts: the stable sort gives both slots to
    token 0 and drops tokens 1 and 3 whole, whose routed output is zero."""
    cfg = _moe_cfg("softmax", 0, 1.25, num_experts=16)
    jp, p = _moe_pair(cfg, seed=2)
    x = np.random.default_rng(3).standard_normal((4, 1, cfg.d_model)).astype(np.float32)
    x[1] = x[3] = x[0]
    assert moe.capacity(cfg, 4) == 1
    jy, _ = _jmoe(cfg, jp, x)
    with _routes() as rec:
        y, _ = moe.moe(cfg, p, torch.from_numpy(x))
    _close(y, jy)
    idx = rec[0]["idx"].numpy()
    assert (idx[1] == idx[0]).all() and (idx[3] == idx[0]).all()
    assert rec[0]["cap"] == 1 and rec[0]["dropped"] >= 4
    assert float(y[0].abs().max()) > 0
    assert float(y[1].abs().max()) == float(y[3].abs().max()) == 0.0
    np.testing.assert_array_equal(np.asarray(jy)[[1, 3]], 0.0)


@pytest.mark.parametrize("case", ["all_tied", "bias_tie_at_k"])
def test_router_ties_keep_the_lower_expert(case):
    """Equal scores: jax.lax.top_k keeps the lower index first, and so does
    the port (a stable descending sort), on every token. all_tied: a zero
    router makes every softmax score equal, so every token picks experts 0
    and 1 (and at 1.25 most of them are dropped). bias_tie_at_k: sigmoid
    scores, top 1, experts 3 and 6 with equal router columns and a bias of
    10 each: every token ranks them first and second, equal, and keeps 3."""
    if case == "all_tied":
        cfg = _moe_cfg("softmax", 0, 1.25)
        jp, p = _moe_pair(cfg)
        jp["router"] = jnp.zeros_like(jp["router"])
        p.router.zero_()
        want = [0, 1]
    else:
        cfg = _moe_cfg("sigmoid", 0, 8.0, num_experts_per_tok=1)
        jp, p = _moe_pair(cfg)
        r = np.array(jp["router"])
        r[:, 6] = r[:, 3]
        bias = np.zeros(cfg.num_experts, np.float32)
        bias[[3, 6]] = 10.0
        jp["router"], jp["router_bias"] = jnp.asarray(r), jnp.asarray(bias)
        p.router.copy_(torch.from_numpy(r))
        p.router_bias.copy_(torch.from_numpy(bias))
        want = [3]
    x = np.random.default_rng(4).standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    _, jidx, _ = jmoe.route(cfg, jp, jnp.asarray(x.reshape(20, -1)))
    _, idx, _ = moe.route(cfg, p, torch.from_numpy(x.reshape(20, -1)))
    assert np.asarray(jidx).tolist() == idx.tolist() == [want] * 20
    jy, jaux = _jmoe(cfg, jp, x)
    y, aux = moe.moe(cfg, p, torch.from_numpy(x))
    _close(y, jy)
    _close(aux, jaux)


def test_moe_token_permutation_equivariance():
    """The port's counterpart of tests/test_properties.py's: with no
    capacity drops the output commutes with a permutation of the tokens."""
    cfg = _moe_cfg("softmax", 0, 16.0).with_(d_model=16, num_experts=4, moe_d_ff=8)
    _, p = _moe_pair(cfg, seed=5)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((1, 12, 16)).astype(np.float32))
    perm = torch.from_numpy(rng.permutation(12))
    y1, _ = moe.moe(cfg, p, x)
    y2, _ = moe.moe(cfg, p, x[:, perm])
    _close(y1[:, perm], y2, 2e-5)


def test_moe_dtype_and_refusals():
    """A bf16 MoE keeps its router and bias in fp32 and routes in fp32; the
    expert-parallel path (``moe_ep``) runs only under a sharding context on
    DTensors: outside one, moe_impl "ep" takes the gather-only dispatch and
    gives its output bit for bit (moe_ep itself is held to the reference in
    tests/test_torch_sharding.py)."""
    cfg = _moe_cfg("sigmoid", 1, 1.25)
    p = moe.MoE(cfg, gen=torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    assert p.router.dtype == p.router_bias.dtype == torch.float32
    assert p.wi.dtype == p.shared_wo.dtype == torch.bfloat16
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator().manual_seed(1))
    with _routes() as rec:
        y, aux = moe.moe(cfg, p, x.bfloat16())
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    # the router saw an fp32 copy of the bf16 activations, through the fp32
    # router: the same ids as routing that copy directly
    _, idx, _ = moe.route(cfg, p, x.bfloat16().float().reshape(10, -1))
    assert torch.equal(rec[0]["idx"], idx)
    y_ep, aux_ep = moe.moe(cfg.with_(moe_impl="ep"), p, x.bfloat16())
    y_gather, aux_gather = moe.moe(cfg.with_(moe_impl="gather"), p, x.bfloat16())
    assert torch.equal(y_ep, y_gather) and torch.equal(aux_ep, aux_gather)


# ------------------------------------------------------------------------ MLA

@pytest.fixture(scope="module")
def mla_pair():
    cfg = smoke_config("deepseek-v3-671b")
    jp = jmla.init_mla(ArrayMaker(jax.random.PRNGKey(7)), cfg)
    return cfg, jp, _load(mla.MLA(cfg), jp)


def _jmla_prefill(cfg):
    return jax.jit(lambda p_, x_, pos_, c_: jmla.mla_attention(cfg, p_, x_, pos_, cache=c_))


def _jmla_cache(cfg, b, n):
    return jmla.make_mla_cache(cfg, b, n, jnp.float32)


def test_mla_attention_matches_jax(mla_pair):
    """The naive prefill: q and k of 16 + 8, v of 16, padded to K1's head_dim
    64, through K1's plain version, against attend_ref's; and the cache."""
    cfg, jp, p = mla_pair
    assert mla.padded_head_dim(cfg) == 64
    assert mla.padded_head_dim(get_config("deepseek-v3-671b")) == 256
    x = np.random.default_rng(8).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S)
    jy, jc = _jmla_prefill(cfg)(jp, jnp.asarray(x), jnp.asarray(pos),
                                _jmla_cache(cfg, B, MAX_LEN))
    y, c = mla.mla_attention(cfg, p, torch.from_numpy(x), torch.from_numpy(pos),
                             cache=mla.make_mla_cache(cfg, B, MAX_LEN, torch.float32, "cpu"))
    _close(y, jy)
    for key in ("c_kv", "k_rope"):
        _close(c[key], jc[key])
    np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(jc["pos"]))
    y0, none = mla.mla_attention(cfg, p, torch.from_numpy(x), torch.from_numpy(pos))
    assert none is None
    _close(y0, jy)


def test_mla_decode_matches_jax_over_steps(mla_pair):
    """The absorbed decode, four steps after a prefill of S, each step's
    output and the compressed cache against the reference's."""
    cfg, jp, p = mla_pair
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    _, jc = _jmla_prefill(cfg)(jp, jnp.asarray(x), jnp.arange(S),
                               _jmla_cache(cfg, B, MAX_LEN))
    _, c = mla.mla_attention(cfg, p, torch.from_numpy(x), torch.arange(S),
                             cache=mla.make_mla_cache(cfg, B, MAX_LEN, torch.float32, "cpu"))
    jdecode = jax.jit(lambda p_, x_, i_, c_: jmla.mla_decode(cfg, p_, x_, i_, c_))
    for t in range(4):
        xt = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        jy, jc = jdecode(jp, jnp.asarray(xt), jnp.asarray(S + t, jnp.int32), jc)
        y, c = mla.mla_decode(cfg, p, torch.from_numpy(xt),
                              torch.tensor(S + t, dtype=torch.int32), c)
        assert y.shape == (B, 1, cfg.d_model)
        _close(y, jy)
    for key in ("c_kv", "k_rope"):
        _close(c[key], jc[key])
    np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(jc["pos"]))
    assert c["pos"].tolist()[:S + 5] == list(range(S + 4)) + [-1]


# ------------------------------------------------------------- the two archs

_JPARAMS = {}


@pytest.fixture(scope="module", params=[(a, cf) for a in ARCHS for cf in (8.0, 1.25)],
                ids=lambda p: f"{p[0]}-cf{p[1]}")
def models(request):
    arch, cf = request.param
    jcfg = jsmoke_config(arch).with_(capacity_factor=cf)
    cfg = smoke_config(arch).with_(capacity_factor=cf)
    assert cfg == cfg.with_(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    jbundle = jmake_model(jcfg)
    if arch not in _JPARAMS:   # the capacity factor does not change the params
        _JPARAMS[arch] = jax.jit(jbundle.init)(jax.random.PRNGKey(0))
    jparams = _JPARAMS[arch]
    bundle = make_model(cfg)
    params = bundle.init(0, device="cpu")
    params.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    return cfg, jbundle, jparams, bundle, params, tokens


def _jbatch(tokens):
    return {"tokens": jnp.asarray(tokens, jnp.int32)}


def _tbatch(tokens):
    return {"tokens": torch.from_numpy(tokens)}


def test_convert_covers_every_param_in_order(models):
    cfg, _, jparams, _, params, _ = models
    assert sum(a.size for a in jax.tree.leaves(jparams)) == sum(
        p.numel() for p in params.parameters())
    plan = layer_plan(cfg)
    assert len(params.blocks) == len(plan) == cfg.num_layers
    k_pre = cfg.first_dense_layers
    assert [s.moe for s in plan] == [False] * k_pre + [True] * (cfg.num_layers - k_pre)
    assert [s.stack for s in plan[:k_pre]] == ["pre.p0"] * k_pre
    for spec, blk in zip(plan, params.blocks):
        assert isinstance(blk.ffn, moe.MoE) == spec.moe
        assert isinstance(blk.attn, mla.MLA) == cfg.mla
    assert (params.mtp is not None) == bool(cfg.mtp_depth)
    want = jparams["pre"]["p0"]["ffn"]["wi"][0] if k_pre else jparams["main"]["p0"]["ffn"][
        "router"][0]
    got = params.blocks[0].ffn.wi if k_pre else params.blocks[0].ffn.router
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_forward_logits_aux_and_mtp(models):
    cfg, jbundle, jparams, bundle, params, tokens = models
    want = jax.jit(lambda p, b: (lambda o: (o.logits, o.value, o.aux_loss, o.mtp_logits))(
        jbundle.forward(p, b)))(jparams, _jbatch(tokens))
    want = dict(zip(("logits", "value", "aux_loss", "mtp_logits"), want))
    with _routes() as rec:
        got = bundle.forward(params, _tbatch(tokens))
    assert got.logits.shape == (B, S, cfg.padded_vocab) and got.logits.dtype == torch.float32
    _close(got.logits, want["logits"])
    _close(got.value, want["value"])
    assert got.aux_loss.dim() == 0 and float(got.aux_loss) > 0
    _close(got.aux_loss, want["aux_loss"])
    if cfg.mtp_depth:
        assert got.mtp_logits.shape == got.logits.shape
        _close(got.mtp_logits, want["mtp_logits"])
    else:
        assert got.mtp_logits is None and want["mtp_logits"] is None
    n_moe = sum(s.moe for s in layer_plan(cfg)) + (1 if cfg.mtp_depth else 0)
    assert len(rec) == n_moe
    if cfg.capacity_factor < 2:
        assert sum(int(r["dropped"]) for r in rec) > 0


def _close_caches(tc, jc, cfg):
    """Layer i of the port is leaf spec.leaf of the JAX stack spec.stack."""
    assert int(tc["index"]) == int(jc["index"])
    keys = ("c_kv", "k_rope") if cfg.mla else ("k", "v")
    for spec, c in zip(layer_plan(cfg), tc["layers"]):
        head, part = spec.stack.split(".")
        j = jc["pre"] if head == "pre" else jc["main"][int(part[1:])]
        for key in keys:
            _close(c[key], j[key][spec.leaf])
        np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(j["pos"][spec.leaf]))


def test_prefill_then_decode(models):
    cfg, jbundle, jparams, bundle, params, tokens = models
    def fields(out_cache):   # jit returns arrays, not ModelOutputs
        out, cache = out_cache
        return (out.logits, out.value, out.aux_loss), cache

    jprefill = jax.jit(lambda p, b: fields(jbundle.prefill(p, b, max_len=MAX_LEN,
                                                           dtype=jnp.float32)))
    jstep = jax.jit(lambda p, t, c: fields(jbundle.decode_step(p, t, c)))
    jout, jc = jprefill(jparams, _jbatch(tokens))
    out, tc = bundle.prefill(params, _tbatch(tokens), max_len=MAX_LEN, dtype=torch.float32)
    _close(out.logits, jout[0])
    _close(out.value, jout[1])
    _close(out.aux_loss, jout[2])
    _close_caches(tc, jc, cfg)
    dropped = 0
    for t in np.random.default_rng(2).integers(0, cfg.vocab_size, (STEPS, B, 1)):
        jout, jc = jstep(jparams, jnp.asarray(t, jnp.int32), jc)
        with _routes() as rec:
            out, tc = bundle.decode_step(params, torch.from_numpy(t), tc)
        dropped += sum(int(r["dropped"]) for r in rec)
        assert out.logits.shape == (B, 1, cfg.padded_vocab)
        _close(out.logits, jout[0])
        _close(out.value, jout[1])
        _close(out.aux_loss, jout[2])
    _close_caches(tc, jc, cfg)
    # two tokens a step, top 2 of 8 experts: cap is 1 at 1.25, 4 at 8.0
    assert rec[0]["cap"] == math.ceil(B * 2 / 8 * cfg.capacity_factor)
    assert (dropped > 0) == (cfg.capacity_factor < 2)


def test_greedy_tokens_equal_jax(models):
    cfg, jbundle, jparams, bundle, params, tokens = models
    want = jgreedy(jbundle, jparams, _jbatch(tokens), steps=STEPS, max_len=MAX_LEN,
                   dtype=jnp.float32)
    got = greedy_generate(bundle, params, _tbatch(tokens), steps=STEPS, max_len=MAX_LEN,
                          dtype=torch.float32)
    assert got.dtype == torch.int32 and got.shape == (B, STEPS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_vtrace_loss_with_router_and_mtp_terms(arch):
    """make_vtrace_loss's value and metrics against the reference's, the
    router term (both archs) and the MTP cross-entropy (deepseek), with a
    mask that zeroes some positions; and every gradient leaf within 1e-4 of
    the leaf's max, through the MoE's gathers and bmm on the CPU."""
    jcfg, cfg = jsmoke_config(arch).with_(capacity_factor=1.25), smoke_config(arch).with_(
        capacity_factor=1.25)
    jbundle, bundle = jmake_model(jcfg), make_model(cfg)
    jparams = jax.jit(jbundle.init)(jax.random.PRNGKey(3))
    batch = jax.tree.map(np.asarray, jbatch(jax.random.PRNGKey(4), B, S, cfg.vocab_size))
    batch["mask"] = batch["mask"].copy()
    batch["mask"][0, 7:] = 0.0
    (jl, jm), jg = jax.jit(jax.value_and_grad(jlosses.make_vtrace_loss(jbundle), has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, batch))
    params = bundle.init(0, device="cpu")
    params.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    params.requires_grad_(True)
    loss, metrics = losses.make_vtrace_loss(bundle)(
        params, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    _close(loss, jl)
    want_keys = {"pg_loss", "value_loss", "entropy_loss", "router_aux", "loss"} | (
        {"mtp_ce"} if cfg.mtp_depth else set())
    assert set(metrics) == set(jm) == want_keys
    for k in want_keys:
        _close(metrics[k], jm[k])
    assert float(metrics["router_aux"]) > 0
    named = dict(params.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()), allow_unused=True)))
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jg))
    for name, g in grads.items():
        w = want[name].numpy()
        if g is None:   # router_bias ranks only: no gradient on either side
            assert name.endswith("router_bias") and not w.any(), name
            continue
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(_np(g), w, atol=1e-4 * scale, rtol=1e-4, err_msg=name)


def test_full_configs_build_and_are_supported():
    """The published configs pass check_supported, at tp 8 too (padded heads
    are ported); only unknown activations are refused."""
    for arch in ARCHS:
        cfg = get_config(arch)
        check_supported(cfg)
        plan = layer_plan(cfg)
        assert len(plan) == cfg.num_layers
        assert sum(not s.moe for s in plan) == cfg.first_dense_layers
    check_supported(smoke_config("qwen3-moe-30b-a3b").with_(tp=8))
    with pytest.raises(NotImplementedError, match="activation 'sigmoid'"):
        check_supported(smoke_config("deepseek-v3-671b").with_(act="sigmoid"))


@pytest.mark.parametrize("score", ["softmax", "sigmoid"])
def test_moe_ep_on_a_one_rank_mesh_matches_jax(score):
    """``moe_ep`` (the ``local_map`` body) under a sharding context on a
    one-rank mesh, the MoE's params and activations DTensors: every expert
    on the one rank, the per-shard capacity equal to ``moe``'s, so the
    output, the router loss and the drops at capacity 1.25 equal the
    reference's ``moe`` (TOL). Its multi-rank layouts are held to the
    reference in tests/test_torch_sharding.py."""
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.sharding.ctx import sharding_ctx
    from repro_torch.sharding.param import distribute_module, shard_tensor
    from repro_torch.sharding.rules import DEFAULT_RULES, filter_rules, placements, safe_spec
    cfg = _moe_cfg(score, 1, 1.25)
    jp, p = _moe_pair(cfg, seed=7)
    x = np.random.default_rng(8).standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    jy, jaux = _jmoe(cfg, jp, x)
    mesh = single_device_mesh("cpu")
    rules = filter_rules(DEFAULT_RULES, mesh)
    distribute_module(p, mesh, rules)
    xt = torch.from_numpy(x)
    with sharding_ctx(mesh, rules), _routes() as rec:
        xd = shard_tensor(xt, mesh, placements(safe_spec(xt.shape, ("act_batch", None, None),
                                                         rules, mesh), mesh))
        y, aux = moe.moe(cfg, p, xd)
    assert type(y).__name__ == "DTensor" and rec and rec[0]["dropped"] > 0
    _close(y.full_tensor(), jy)
    _close(aux.full_tensor(), jaux)
