"""The port's encoder-decoder against the JAX package at
smoke_config("seamless-m4t-large-v2") (2 encoder and 2 decoder layers,
4 query heads on 2 kv heads of 16, 8 frames of 24), on params converted by
``params_from_jax``, in fp32 on the CPU, with inputs drawn from numpy
seeds.

Tolerance 1e-4 (absolute and relative), as in tests/test_torch_dense.py:
both sides compute in fp32, so what differs is the order of summation in
the products. A wrong mask (a causal encoder, a masked cross-attention),
rope where it does not belong (cross-attention) or a missing bias moves the
logits by 1e-2 or more. The prompts have 12 tokens against 8 frames, so the
cross-attention's keys have a length of their own. The bf16 cache under an
fp32 model is held at bf16's 5e-2, as the LM's is.

Beside the model: the ungated MLP against ``repro.nn.mlp.mlp``, K1's plain
version with k and v of a length of their own against the JAX model's
``attend_ref(kind="bidir")`` (1e-5: one call, summation order only), and
the wrapper's refusal of such a length with a causal mask or a window.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import make_model as jmake_model  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke_config  # noqa: E402
from repro.launch.serve import greedy_generate as jgreedy  # noqa: E402
from repro.nn import mlp as jmlp  # noqa: E402
from repro.nn.attention import attend_ref  # noqa: E402
from repro_torch.configs.registry import make_model, smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve_policy  # noqa: E402
from repro_torch.launch.serve import greedy_generate  # noqa: E402
from repro_torch.nn.mlp import MLP, mlp  # noqa: E402

TOL = 1e-4
ARCH = "seamless-m4t-large-v2"
B, S, MAX_LEN, STEPS = 2, 12, 32, 6
LEAVES = ("k", "v", "pos", "xk", "xv")


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = jsmoke_config(ARCH), smoke_config(ARCH)
    assert cfg == cfg.with_(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    jbundle = jmake_model(jcfg)
    jparams = jbundle.init(jax.random.PRNGKey(0))
    bundle = make_model(cfg)
    params = bundle.init(0, device="cpu")
    params.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, S))
    frames = rng.standard_normal((B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return cfg, jbundle, jparams, bundle, params, tokens, frames


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _jbatch(tokens, frames):
    return {"tokens": jnp.asarray(tokens, jnp.int32), "frontend": jnp.asarray(frames)}


def _tbatch(tokens, frames):
    return {"tokens": torch.from_numpy(tokens), "frontend": torch.from_numpy(frames)}


def _close_caches(tc, jc, tol=TOL):
    """Layer i of the port's cache is leaf [i] of the JAX cache's stacked
    "dec" entries: every leaf, and its dtype."""
    assert int(tc["index"]) == int(jc["index"]) and tc["index"].dtype == torch.int32
    assert set(jc["dec"]) == set(LEAVES)
    for i, c in enumerate(tc["dec"]):
        assert set(c) == set(LEAVES)
        for name in LEAVES:
            want = np.asarray(jc["dec"][name][i])
            assert str(c[name].dtype)[6:] == str(jc["dec"][name].dtype), name
            if name == "pos":
                np.testing.assert_array_equal(c[name].numpy(), want)
            else:
                _close(c[name], want, tol)


def test_convert_covers_every_param(models):
    cfg, _, jparams, _, params, _, _ = models
    n_jax = sum(a.size for a in jax.tree.leaves(jparams))
    assert sum(p.numel() for p in params.parameters()) == n_jax
    assert set(params_from_jax(cfg, jax.tree.map(np.asarray, jparams))) == set(
        params.state_dict())
    assert (len(params.enc), len(params.dec)) == (cfg.enc_layers, cfg.dec_layers) == (2, 2)
    assert params.enc[0].mlp.wg is None and params.dec[0].mlp.bi is not None


def test_forward_logits_and_value(models):
    cfg, jbundle, jparams, bundle, params, tokens, frames = models
    want = jbundle.forward(jparams, _jbatch(tokens, frames))
    got = bundle.forward(params, _tbatch(tokens, frames))
    assert got.logits.shape == (B, S, cfg.padded_vocab) and got.logits.dtype == torch.float32
    _close(got.logits, want.logits)
    _close(got.value, want.value)


def test_prefill_then_decode_every_cache_leaf(models):
    cfg, jbundle, jparams, bundle, params, tokens, frames = models
    jout, jc = jbundle.prefill(jparams, _jbatch(tokens, frames), max_len=MAX_LEN,
                               dtype=jnp.float32)
    out, tc = bundle.prefill(params, _tbatch(tokens, frames), max_len=MAX_LEN,
                             dtype=torch.float32)
    _close(out.logits, jout.logits)
    _close(out.value, jout.value)
    _close_caches(tc, jc)
    assert tc["dec"][0]["xk"].shape == (B, cfg.frontend_tokens, cfg.num_kv_heads, cfg.head_dim)
    for t in np.random.default_rng(2).integers(0, cfg.vocab_size, (3, B, 1)):
        jout, jc = jbundle.decode_step(jparams, jnp.asarray(t, jnp.int32), jc)
        out, tc = bundle.decode_step(params, torch.from_numpy(t), tc)
        assert out.logits.shape == (B, 1, cfg.padded_vocab)
        _close(out.logits, jout.logits)
        _close(out.value, jout.value)
    _close_caches(tc, jc)
    assert int(tc["index"]) == S + 3
    with pytest.raises(ValueError, match="max_len"):
        bundle.prefill(params, _tbatch(tokens, frames), max_len=S - 1)


def test_greedy_tokens_equal_jax(models):
    cfg, jbundle, jparams, bundle, params, tokens, frames = models
    want = jgreedy(jbundle, jparams, _jbatch(tokens, frames), steps=STEPS, max_len=MAX_LEN,
                   dtype=jnp.float32)
    got = greedy_generate(bundle, params, _tbatch(tokens, frames), steps=STEPS,
                          max_len=MAX_LEN, dtype=torch.float32)
    assert got.dtype == torch.int32 and got.shape == (B, STEPS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bf16_cache_under_fp32_model(models):
    """The serving default's cache dtype under fp32 compute: the self-
    attention caches are bf16, while the cross K/V keep the encoder
    output's fp32, as the reference's prefill leaves them; a decode step
    stays within bf16 tolerance of the JAX model's."""
    cfg, jbundle, jparams, bundle, params, tokens, frames = models
    jout, jc = jbundle.prefill(jparams, _jbatch(tokens, frames), max_len=MAX_LEN)
    out, tc = bundle.prefill(params, _tbatch(tokens, frames), max_len=MAX_LEN)
    assert tc["dec"][0]["k"].dtype == torch.bfloat16
    assert tc["dec"][0]["xk"].dtype == torch.float32
    _close_caches(tc, jc, tol=5e-2)
    init = bundle.init_cache(B, MAX_LEN, device="cpu")
    assert init["dec"][0]["xk"].dtype == torch.bfloat16 and len(init["dec"]) == cfg.dec_layers
    t = np.full((B, 1), 3)
    jout, _ = jbundle.decode_step(jparams, jnp.asarray(t, jnp.int32), jc)
    out, _ = bundle.decode_step(params, torch.from_numpy(t), tc)
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(jout.logits), atol=5e-2,
                               rtol=5e-2)


def test_serve_reproduces_greedy_generate():
    """Three clients through the InferenceServer, each with its own seeded
    prompt and frames: with full batches each client's tokens are its
    greedy continuation."""
    cfg = smoke_config(ARCH)
    clients, tokens = 3, 4
    out = serve_policy.serve(cfg, clients=clients, prompt_len=10, tokens=tokens, max_len=32,
                             device="cpu", deadline_ms=60_000.0, seed=5)
    assert out["stats"]["batches"] == tokens
    assert out["frames"].shape == (clients, cfg.frontend_tokens, cfg.frontend_dim)
    bundle = make_model(cfg)
    params = bundle.init(5, device="cpu", dtype=torch.float32)
    want = greedy_generate(bundle, params, {"tokens": torch.from_numpy(out["prompts"]),
                                            "frontend": torch.from_numpy(out["frames"])},
                           steps=tokens + 1, max_len=32, dtype=torch.float32)
    for cid in range(clients):
        assert [out["first"][cid]] + out["tokens"][cid] == want[cid].tolist()


@pytest.mark.parametrize("gated,bias", [(False, True), (False, False), (True, True)])
def test_mlp_against_jax(gated, bias):
    d, f = 24, 40
    jp = jmlp.init_mlp(lambda name, shape, axes, init: init(
        jax.random.PRNGKey(len(name) + 7 * len(shape)), shape), d, f, gated=gated, bias=bias)
    jp = {k: v + 0.1 for k, v in jp.items()}      # nonzero biases
    p = MLP(d, f, gated=gated, bias=bias)
    p.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in jp.items()})
    assert (p.wg is None) != gated
    x = np.random.default_rng(3).standard_normal((2, 5, d)).astype(np.float32)
    for act in ("relu", "silu"):
        _close(mlp(p, torch.from_numpy(x), act), jmlp.mlp(jp, jnp.asarray(x), act), 1e-5)


@pytest.mark.parametrize("s,skv,h,kh,d", [
    (12, 8, 4, 2, 16),     # the reduced config's cross call
    (5, 33, 4, 1, 16),     # S_kv > S, 4 query heads a kv head
    (40, 7, 2, 2, 64),     # S_kv < S
    (1, 16, 16, 16, 64),   # one query row: a cross decode step's shape
])
def test_flash_attention_plain_kv_len_against_attend_ref(s, skv, h, kh, d):
    rng = np.random.default_rng(s + skv)
    q = rng.standard_normal((2, s, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((2, skv, kh, d)).astype(np.float32) for _ in range(2))
    got = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=False,
                              scale=d ** -0.5)
    rep = lambda x: jnp.repeat(jnp.asarray(x), h // kh, axis=2)   # noqa: E731
    want = attend_ref(jnp.asarray(q), rep(k), rep(v), jnp.zeros((2, s), jnp.int32),
                      jnp.zeros((2, skv), jnp.int32), kind="bidir", scale=d ** -0.5)
    assert got.shape == (2, s, h, d)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("kw", [{"causal": True}, {"causal": False, "window": 4},
                                {"causal": True, "window": 4}])
def test_kv_len_with_a_mask_raises(kw):
    q, k = torch.zeros(1, 6, 2, 16), torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="no causal mask and no window"):
        ops.flash_attention(q, k, k, **kw)


def test_padded_heads_match_jax_and_sharded_serving_matches():
    """tp 4 with 6 query heads over 2 kv heads: every attention (encoder,
    decoder self- and cross-attention) holds 8 heads, a group of 4, the 2
    padded heads masked before wo, and the vocab is padded to 512. Forward,
    prefill and 3 decode steps' logits against the reference on converted
    params (1e-4); random values in the padded rows of every wq and wo
    change nothing, bit for bit; and the same model served with its params
    as DTensors on a one-rank mesh under the decode rules gives the plain
    path's greedy tokens."""
    pad = dict(num_heads=6, num_kv_heads=2, tp=4)
    jcfg, cfg = jsmoke_config(ARCH).with_(**pad), smoke_config(ARCH).with_(**pad)
    assert cfg.padded_heads == 8 and cfg.padded_vocab == 512
    jbundle, bundle = jmake_model(jcfg), make_model(cfg)
    jparams = jbundle.init(jax.random.PRNGKey(0))
    params = bundle.init(0, device="cpu")
    params.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (B, S))
    frames = rng.standard_normal((B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    feed = rng.integers(0, cfg.vocab_size, (3, B, 1))

    def port_logits(p):
        with torch.no_grad():
            got = [bundle.forward(p, _tbatch(tokens, frames)).logits]
            out, tc = bundle.prefill(p, _tbatch(tokens, frames), max_len=MAX_LEN,
                                     dtype=torch.float32)
            got.append(out.logits)
            for t in feed:
                out, tc = bundle.decode_step(p, torch.from_numpy(t), tc)
                got.append(out.logits)
        return got

    want = [jbundle.forward(jparams, _jbatch(tokens, frames)).logits]
    jout, jc = jbundle.prefill(jparams, _jbatch(tokens, frames), max_len=MAX_LEN,
                               dtype=jnp.float32)
    want.append(jout.logits)
    for t in feed:
        jout, jc = jbundle.decode_step(jparams, jnp.asarray(t, jnp.int32), jc)
        want.append(jout.logits)
    got = port_logits(params)
    for g, w in zip(got, want):
        _close(g, w)
    with torch.no_grad():
        for name, t in params.named_parameters():
            if name.endswith(("attn.wq", "xattn.wq")):
                t[:, cfg.num_heads:] = torch.randn_like(t[:, cfg.num_heads:])
            elif name.endswith(("attn.wo", "xattn.wo")):
                t[cfg.num_heads:] = torch.randn_like(t[cfg.num_heads:])
    for g, w in zip(port_logits(params), got):
        assert torch.equal(g, w)
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.launch.specs import rules_for
    plain = serve_policy.serve(cfg, clients=2, prompt_len=6, tokens=3, max_len=12,
                               device="cpu", params=params)
    mesh = single_device_mesh("cpu")
    sharded = serve_policy.serve(cfg, clients=2, prompt_len=6, tokens=3, max_len=12,
                                 device="cpu", params=params, mesh=mesh,
                                 rules=rules_for(cfg, mesh, "decode"))
    assert type(params.dec[0].attn.wq).__name__ == "DTensor"
    assert sharded["tokens"] == plain["tokens"] and sharded["first"] == plain["first"]
