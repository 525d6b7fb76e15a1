"""The port's dense LM family against the JAX package at the reduced configs
of gemma2-9b, starcoder2-15b, qwen2.5-32b and internvl2-1b, on params
converted by ``params_from_jax``, in fp32 on the CPU, with inputs drawn
from numpy seeds.

Tolerance 1e-4 (absolute and relative), as in tests/test_torch_lm.py: both
sides compute in fp32, so what differs is the order of summation in the
products and the masking constants (-2e38 additive in the JAX model, -1e30
in the kernels' plain versions), which give the same zero weight to every
masked key. A wrong mask, window, softcap, bias, norm or layer order moves
the logits by 1e-2 or more. K2's plain version with a softcap is held to
the JAX model's ``attend_ref`` at 1e-5: one call, summation order only.

The reduced gemma2 has 4 layers (local, global, local, global) and a window
of 32: a 28-token prompt and 7 decode steps write positions past 32, so
the local layers' rings wrap in decode, and a 40-token prompt wraps them in
the prefill, where K1's window mask cuts the attention.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import make_model as jmake_model  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke_config  # noqa: E402
from repro.launch.serve import greedy_generate as jgreedy  # noqa: E402
from repro.nn.attention import attend_ref  # noqa: E402
from repro_torch.configs.registry import make_model, smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import greedy_generate  # noqa: E402

TOL = 1e-4
ARCHS = ("gemma2-9b", "starcoder2-15b", "qwen2.5-32b", "internvl2-1b")
B, S, MAX_LEN, STEPS = 2, 28, 48, 7      # S + STEPS = 35 > the reduced window of 32


def _build(cfg, jcfg, seed=0):
    jbundle = jmake_model(jcfg)
    jparams = jbundle.init(jax.random.PRNGKey(seed))
    bundle = make_model(cfg)
    params = bundle.init(0, device="cpu")
    params.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    return jbundle, jparams, bundle, params


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    jcfg, cfg = jsmoke_config(arch), smoke_config(arch)
    assert cfg == cfg.with_(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    jbundle, jparams, bundle, params = _build(cfg, jcfg)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    return cfg, jbundle, jparams, bundle, params, tokens


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _jbatch(tokens, frontend=None):
    batch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    if frontend is not None:
        batch["frontend"] = jnp.asarray(frontend)
    return batch


def _tbatch(tokens, frontend=None):
    batch = {"tokens": torch.from_numpy(tokens)}
    if frontend is not None:
        batch["frontend"] = torch.from_numpy(frontend)
    return batch


def _close_caches(cfg, tc, jc):
    """Layer i of the port is leaf [i // P] of the JAX stack main[i % P]."""
    period = len(cfg.attn_pattern)
    assert int(tc["index"]) == int(jc["index"])
    for i, c in enumerate(tc["layers"]):
        j = jc["main"][i % period]
        _close(c["k"], j["k"][i // period])
        _close(c["v"], j["v"][i // period])
        np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(j["pos"][i // period]))


def test_convert_covers_every_param(models):
    cfg, _, jparams, _, params, _ = models
    n_jax = sum(a.size for a in jax.tree.leaves(jparams))
    assert sum(p.numel() for p in params.parameters()) == n_jax
    assert set(params_from_jax(cfg, jax.tree.map(np.asarray, jparams))) == set(
        params.state_dict())
    assert len(params.blocks) == cfg.num_layers


def test_forward_logits_and_value(models):
    cfg, jbundle, jparams, bundle, params, tokens = models
    want = jbundle.forward(jparams, _jbatch(tokens))
    got = bundle.forward(params, _tbatch(tokens))
    assert got.logits.shape == (B, S, cfg.padded_vocab) and got.logits.dtype == torch.float32
    _close(got.logits, want.logits)
    _close(got.value, want.value)


def test_prefill_then_decode_past_the_wrap(models):
    cfg, jbundle, jparams, bundle, params, tokens = models
    jout, jc = jbundle.prefill(jparams, _jbatch(tokens), max_len=MAX_LEN, dtype=jnp.float32)
    out, tc = bundle.prefill(params, _tbatch(tokens), max_len=MAX_LEN, dtype=torch.float32)
    _close(out.logits, jout.logits)
    _close(out.value, jout.value)
    _close_caches(cfg, tc, jc)
    steps = np.random.default_rng(2).integers(0, cfg.vocab_size, (STEPS, B, 1))
    for t in steps:
        jout, jc = jbundle.decode_step(jparams, jnp.asarray(t, jnp.int32), jc)
        out, tc = bundle.decode_step(params, torch.from_numpy(t), tc)
        assert out.logits.shape == (B, 1, cfg.padded_vocab)
        _close(out.logits, jout.logits)
        _close(out.value, jout.value)
    _close_caches(cfg, tc, jc)
    if "local" in cfg.attn_pattern:     # the ring wrapped: slot 0 holds position 32
        assert tc["layers"][0]["k"].shape[1] == cfg.local_window == 32
        assert int(tc["layers"][0]["pos"][0]) == 32


def test_greedy_tokens_equal_jax(models):
    cfg, jbundle, jparams, bundle, params, tokens = models
    want = jgreedy(jbundle, jparams, _jbatch(tokens), steps=STEPS, max_len=MAX_LEN,
                   dtype=jnp.float32)
    got = greedy_generate(bundle, params, _tbatch(tokens), steps=STEPS, max_len=MAX_LEN,
                          dtype=torch.float32)
    assert got.dtype == torch.int32 and got.shape == (B, STEPS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gemma2_prompt_longer_than_the_window():
    """A 40-token prompt: K1's window mask cuts the local layers' prefill, and
    each ring keeps positions 8..39 at slot pos % 32; then decode steps.
    The attention softcap is 0.5 on both sides: at the reduced widths the
    scaled logits are about 0.25 a standard deviation, which gemma2's cap
    of 50 leaves within 1e-5, so only a small cap shows that K1's and K2's
    plain versions take it where the JAX model does."""
    arch = "gemma2-9b"
    cfg, jcfg = smoke_config(arch).with_(attn_softcap=0.5), jsmoke_config(arch).with_(
        attn_softcap=0.5)
    jbundle, jparams, bundle, params = _build(cfg, jcfg, seed=3)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, 40))
    jout, jc = jbundle.prefill(jparams, _jbatch(tokens), max_len=56, dtype=jnp.float32)
    out, tc = bundle.prefill(params, _tbatch(tokens), max_len=56, dtype=torch.float32)
    _close(out.logits, jout.logits)
    _close_caches(cfg, tc, jc)
    assert sorted(tc["layers"][0]["pos"].tolist()) == list(range(8, 40))
    uncapped, _ = make_model(cfg.with_(attn_softcap=None)).prefill(
        params, _tbatch(tokens), max_len=56, dtype=torch.float32)
    assert float((uncapped.logits - out.logits).abs().max()) > 1e-2
    for t in np.random.default_rng(5).integers(0, cfg.vocab_size, (4, B, 1)):
        jout, jc = jbundle.decode_step(jparams, jnp.asarray(t, jnp.int32), jc)
        out, tc = bundle.decode_step(params, torch.from_numpy(t), tc)
        _close(out.logits, jout.logits)
    _close_caches(cfg, tc, jc)
    # the last step without the cap in decode alone: K2's cap moved it
    uncapped, _ = make_model(cfg.with_(attn_softcap=None)).decode_step(
        params, torch.from_numpy(t), {**tc, "index": tc["index"] - 1})
    assert float((uncapped.logits - out.logits).abs().max()) > 1e-3


def test_internvl2_frontend_in_forward_and_prefill():
    """The modality stub: projected patch embeddings (B, 8, 24) go before the
    tokens, in forward and in prefill; decode continues after them."""
    arch = "internvl2-1b"
    cfg = smoke_config(arch)
    jbundle, jparams, bundle, params = _build(cfg, jsmoke_config(arch))
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab_size, (B, 12))
    fe = rng.standard_normal((B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    want = jbundle.forward(jparams, _jbatch(tokens, fe))
    got = bundle.forward(params, _tbatch(tokens, fe))
    assert got.logits.shape == (B, 12 + cfg.frontend_tokens, cfg.padded_vocab)
    _close(got.logits, want.logits)
    _close(got.value, want.value)
    jout, jc = jbundle.prefill(jparams, _jbatch(tokens, fe), max_len=32, dtype=jnp.float32)
    out, tc = bundle.prefill(params, _tbatch(tokens, fe), max_len=32, dtype=torch.float32)
    _close(out.logits, jout.logits)
    _close_caches(cfg, tc, jc)
    assert int(tc["index"]) == 12 + cfg.frontend_tokens
    t = rng.integers(0, cfg.vocab_size, (B, 1))
    jout, _ = jbundle.decode_step(jparams, jnp.asarray(t, jnp.int32), jc)
    out, _ = bundle.decode_step(params, torch.from_numpy(t), tc)
    _close(out.logits, jout.logits)
    with pytest.raises(ValueError, match="max_len"):
        bundle.prefill(params, _tbatch(tokens, fe), max_len=16)


@pytest.mark.parametrize("arch", ["gemma2-9b", "qwen2.5-32b"])
def test_r2d2_q_head(arch):
    """algo="r2d2" with num_actions: the q head's values (B, S, A) take the
    logits' place, in forward, prefill and decode."""
    cfg = smoke_config(arch).with_(algo="r2d2", num_actions=6)
    jcfg = jsmoke_config(arch).with_(algo="r2d2", num_actions=6)
    jbundle, jparams, bundle, params = _build(cfg, jcfg)
    assert tuple(params.q_head.w.shape) == (cfg.d_model, 6)
    # the q head's bias starts at zeros: give it values, on both sides
    b = np.random.default_rng(7).standard_normal(6).astype(np.float32)
    jparams = dict(jparams, q_head=dict(jparams["q_head"], b=jnp.asarray(b)))
    params.q_head.b.data = torch.from_numpy(b)
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, (B, 10))
    want = jbundle.forward(jparams, _jbatch(tokens))
    got = bundle.forward(params, _tbatch(tokens))
    assert got.logits.shape == (B, 10, 6)
    _close(got.logits, want.logits)
    _close(got.value, want.value)
    jout, jc = jbundle.prefill(jparams, _jbatch(tokens), max_len=16, dtype=jnp.float32)
    out, tc = bundle.prefill(params, _tbatch(tokens), max_len=16, dtype=torch.float32)
    _close(out.logits, jout.logits)
    t = np.full((B, 1), 5)
    jout, _ = jbundle.decode_step(jparams, jnp.asarray(t, jnp.int32), jc)
    out, _ = bundle.decode_step(params, torch.from_numpy(t), tc)
    _close(out.logits, jout.logits)


def _k2_inputs(seed, b, s, h, kh, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    # logits of about 40 a standard deviation, so that the cap of 50 bends them
    k = (rng.standard_normal((b, s, kh, d)) * 10).astype(np.float32)
    v = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("softcap", [50.0, None])
@pytest.mark.parametrize("case", ["global", "ring_wrapped", "ring_filling"])
def test_decode_attention_plain_softcap_matches_attend_ref(case, softcap):
    """K2's plain version with lengths against the JAX decode's attend_ref
    with the cache's positions: a global cache with 37 of 48 slots filled, a
    ring of 32 slots after the wrap (positions 45..76, slot = pos % 32), and
    a ring of 32 with 20 slots filled; 4 query heads on 2 kv heads of 16."""
    b, h, kh, d, scale = 2, 4, 2, 16, 1.0
    s = 48 if case == "global" else 32
    q, k, v = _k2_inputs(9, b, s, h, kh, d)
    if case == "global":
        index, kind, window = 36, "global", 0
        pos = np.where(np.arange(s) <= index, np.arange(s), -1)
    elif case == "ring_wrapped":
        index, kind, window = 76, "local", 32
        pos = np.empty(s, np.int64)
        for p in range(index - s + 1, index + 1):
            pos[p % s] = p
    else:
        index, kind, window = 19, "local", 32
        pos = np.where(np.arange(s) <= index, np.arange(s), -1)
    n_valid = int((pos >= 0).sum())
    got = ops.decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v),
                                     torch.full((b,), n_valid, dtype=torch.int32),
                                     scale=scale, softcap=softcap)
    rep = lambda x: jnp.repeat(jnp.asarray(x), h // kh, axis=2)     # noqa: E731
    want = attend_ref(jnp.asarray(q)[:, None], rep(k), rep(v),
                      jnp.full((b, 1), index), jnp.broadcast_to(jnp.asarray(pos), (b, s)),
                      kind=kind, window=window, scale=scale, softcap=softcap)[:, 0]
    _close(got, want, 1e-5)
    if softcap:    # the cap mattered
        plain = ops.decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                           torch.from_numpy(v),
                                           torch.full((b,), n_valid, dtype=torch.int32),
                                           scale=scale)
        assert float((plain - got).abs().max()) > 1e-2
