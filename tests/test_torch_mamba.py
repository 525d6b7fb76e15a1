"""The port's Mamba2 against the JAX package at smoke_config("mamba2-2.7b"),
on params converted by ``params_from_jax``, in fp32 on the CPU.

Tolerance 1e-4 (absolute and relative): both sides compute the same chunked
SSD algorithm in fp32 (the port's CPU path is the plain version of K3), so
what differs is the order of summation in the products and cumulative sums
(XLA against PyTorch). Over four layers that stays near 1e-6; 1e-4 leaves
room without hiding a wrong decay, conv shift, gate or norm, which each
move logits by 1e-2 or more.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import make_model as jmake_model  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke_config  # noqa: E402
from repro.launch.serve import greedy_generate as jgreedy  # noqa: E402
from repro_torch.configs.registry import make_model, smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.serve import greedy_generate  # noqa: E402

TOL = 1e-4
ARCH = "mamba2-2.7b"
B, S = 2, 18           # one 16-step chunk of the smoke config and a tail of 2


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = jsmoke_config(ARCH), smoke_config(ARCH)
    assert cfg == cfg.with_(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    assert cfg.ssm_chunk == 16 and cfg.tie_embeddings
    jbundle = jmake_model(jcfg)
    jparams = jbundle.init(jax.random.PRNGKey(0))
    bundle = make_model(cfg)
    params = bundle.init(0, device="cpu")
    params.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    return jbundle, jparams, bundle, params, tokens


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def test_convert_covers_every_param(models):
    _, jparams, _, params, _ = models
    cfg = smoke_config(ARCH)
    n_jax = sum(a.size for a in jax.tree.leaves(jparams))
    assert sum(p.numel() for p in params.parameters()) == n_jax
    sd = params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    assert set(sd) == set(params.state_dict())
    assert "embed.unembed" not in sd and "blocks.3.ssd.conv.w" in sd
    assert tuple(sd["blocks.0.ssd.conv.w"].shape) == (cfg.ssm_conv, 128 + 2 * 16)
    assert len(params.blocks) == cfg.num_layers


def test_forward_logits_and_value(models):
    jbundle, jparams, bundle, params, tokens = models
    want = jbundle.forward(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    got = bundle.forward(params, {"tokens": torch.from_numpy(tokens)})
    assert got.logits.shape == (B, S, 277) and got.logits.dtype == torch.float32
    _close(got.logits, want.logits)
    _close(got.value, want.value)


def _jstates(jc):
    ssm, conv = jc["states"]
    return np.asarray(ssm), np.asarray(conv), int(jc["index"])


def _tstates(tc):
    layers = tc["layers"]
    return (torch.stack([st for st, _ in layers]), torch.stack([cv for _, cv in layers]),
            int(tc["index"]))


def test_prefill_then_three_decode_steps(models):
    jbundle, jparams, bundle, params, tokens = models
    jout, jc = jbundle.prefill(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
                               dtype=jnp.float32)
    out, tc = bundle.prefill(params, {"tokens": torch.from_numpy(tokens)},
                             max_len=None, dtype=torch.float32)
    _close(out.logits, jout.logits)
    _close(out.value, jout.value)
    (jssm, jconv, jidx), (tssm, tconv, tidx) = _jstates(jc), _tstates(tc)
    assert tidx == jidx == S
    assert tssm.dtype == torch.float32 and tuple(tssm.shape) == jssm.shape
    assert tuple(tconv.shape) == jconv.shape
    _close(tssm, jssm)
    _close(tconv, jconv)

    steps = np.random.default_rng(2).integers(0, 277, (3, B, 1))
    for t in steps:
        jout, jc = jbundle.decode_step(jparams, jnp.asarray(t, jnp.int32), jc)
        out, tc = bundle.decode_step(params, torch.from_numpy(t), tc)
        assert out.logits.shape == (B, 1, 277)
        _close(out.logits, jout.logits)
        _close(out.value, jout.value)
    (jssm, jconv, jidx), (tssm, tconv, tidx) = _jstates(jc), _tstates(tc)
    assert tidx == jidx == S + 3
    _close(tssm, jssm)
    _close(tconv, jconv)


def test_prefill_shorter_than_the_conv_window(models):
    """A 2-token prompt: the conv state keeps W-1 = 3 pre-conv rows, the
    first of them still the zeros it started with."""
    jbundle, jparams, bundle, params, tokens = models
    short = tokens[:, :2]
    jout, jc = jbundle.prefill(jparams, {"tokens": jnp.asarray(short, jnp.int32)},
                               dtype=jnp.float32)
    out, tc = bundle.prefill(params, {"tokens": torch.from_numpy(short)}, dtype=torch.float32)
    _close(out.logits, jout.logits)
    (jssm, jconv, _), (tssm, tconv, _) = _jstates(jc), _tstates(tc)
    _close(tssm, jssm)
    _close(tconv, jconv)
    assert bool((tconv[:, :, 0] == 0).all())


def test_greedy_generate_tokens_equal_jax(models):
    jbundle, jparams, bundle, params, tokens = models
    want = jgreedy(jbundle, jparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
                   steps=8, max_len=64, dtype=jnp.float32)
    got = greedy_generate(bundle, params, {"tokens": torch.from_numpy(tokens)},
                          steps=8, max_len=64, dtype=torch.float32)
    assert got.dtype == torch.int32 and got.shape == (B, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bf16_cache_decode_stays_close(models):
    """The serving default: a bf16 conv state with fp32 compute (the SSM
    state stays fp32). The port keeps the conv state in the cache dtype
    after a decode step, where the JAX model promotes it to fp32; the
    logits stay within bf16 tolerance of the JAX model's."""
    jbundle, jparams, bundle, params, tokens = models
    jout, jc = jbundle.prefill(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    out, tc = bundle.prefill(params, {"tokens": torch.from_numpy(tokens)})
    assert tc["layers"][0][1].dtype == torch.bfloat16
    assert tc["layers"][0][0].dtype == torch.float32
    t = np.full((B, 1), 3)
    for _ in range(2):
        jout, jc = jbundle.decode_step(jparams, jnp.asarray(t, jnp.int32), jc)
        out, tc = bundle.decode_step(params, torch.from_numpy(t), tc)
    assert tc["layers"][0][1].dtype == torch.bfloat16
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(jout.logits),
                               atol=5e-2, rtol=5e-2)


def test_init_cache_ignores_max_len():
    bundle = make_model(smoke_config(ARCH))
    a = bundle.init_cache(2, 8, device="cpu")
    b = bundle.init_cache(2, 4096, device="cpu")
    assert [tuple(t.shape) for t in a["layers"][0]] == [tuple(t.shape) for t in b["layers"][0]]
    assert len(a["layers"]) == 4 and int(a["index"]) == 0


def test_unported_norm_raises():
    with pytest.raises(NotImplementedError, match="layernorm"):
        make_model(smoke_config(ARCH).with_(norm="layernorm"))
