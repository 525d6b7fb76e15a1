"""The port's RecurrentGemma against the JAX package at
smoke_config("recurrentgemma-2b") (5 layers: rglru, rglru, local, rglru,
rglru; 4 query heads on 1 kv head of 16; lru_width 64; window 32), on
params converted by ``params_from_jax``, in fp32 on the CPU.

Tolerance 1e-4 (absolute and relative): both sides compute in fp32, so what
differs is the order of summation (the port's scan is a loop, JAX's an
associative scan; PyTorch's BLAS against XLA's dots) and the masking
constants (-2e38 additive in the JAX model, -1e30 in the kernels' plain
versions), which give the same zero weight to every masked key. Over five
layers that stays near 1e-6; 1e-4 leaves room without hiding a wrong
window, ring slot, gate, norm offset or GELU form, which each move logits
by 1e-3 or more.
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
from repro_torch.models.recurrentgemma import layer_kinds  # noqa: E402

TOL = 1e-4
ARCH = "recurrentgemma-2b"
B, S, MAX_LEN = 2, 40, 64      # S > the window of 32: the ring wraps in prefill


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = jsmoke_config(ARCH), smoke_config(ARCH)
    assert cfg == cfg.with_(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    assert cfg.num_layers == 5 and cfg.local_window == 32 and cfg.num_kv_heads == 1
    jbundle = jmake_model(jcfg)
    jparams = jbundle.init(jax.random.PRNGKey(0))
    # the gemma norms start at zero scale; give them values so that a missing
    # (1 + scale) shows
    leaves, tree = jax.tree.flatten_with_path(jparams)
    rng = np.random.default_rng(0)
    jparams = jax.tree.unflatten(tree, [
        a + jnp.asarray(rng.standard_normal(a.shape) * 0.2, a.dtype)
        if "scale" in jax.tree_util.keystr(path) else a for path, a in leaves])
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
    assert layer_kinds(cfg) == ["rglru", "rglru", "local", "rglru", "rglru"]
    assert "embed.unembed" not in sd and "blocks.2.mix.wq" in sd and "blocks.4.mix.lam" in sd
    # main.p{k}[j] is layer 3j + k; rest{j} follows the scanned periods
    np.testing.assert_array_equal(sd["blocks.1.mix.lam"].numpy(),
                                  np.asarray(jparams["main"]["p1"]["mix"]["lam"][0]))
    np.testing.assert_array_equal(sd["blocks.4.mix.gate_a"].numpy(),
                                  np.asarray(jparams["rest1"]["mix"]["gate_a"]))
    assert tuple(sd["blocks.2.mix.wk"].shape) == (cfg.d_model, 1, cfg.head_dim)


def test_forward_logits_and_value(models):
    jbundle, jparams, bundle, params, tokens = models
    want = jbundle.forward(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    got = bundle.forward(params, {"tokens": torch.from_numpy(tokens)})
    assert got.logits.shape == (B, S, 277) and got.logits.dtype == torch.float32
    _close(got.logits, want.logits)
    _close(got.value, want.value)


def _jlayers(cfg, jc):
    """The JAX cache (stacked periods, then rest{j}) as one state per layer."""
    period = len(cfg.block_pattern)
    n_scan = cfg.num_layers // period
    out = [jax.tree.map(lambda a: a[j], jc["main"][k])
           for j in range(n_scan) for k in range(period)]
    return out + [jc[f"rest{j}"] for j in range(cfg.num_layers - n_scan * period)]


def _check_caches(cfg, tc, jc):
    assert int(tc["index"]) == int(jc["index"])
    for kind, t, j in zip(layer_kinds(cfg), tc["layers"], _jlayers(cfg, jc)):
        if kind == "rglru":
            assert t[0].dtype == torch.float32
            _close(t[0], j[0])
            _close(t[1], j[1])
        else:
            assert tuple(t["k"].shape) == j["k"].shape
            _close(t["k"], j["k"])
            _close(t["v"], j["v"])
            np.testing.assert_array_equal(t["pos"].numpy(), np.asarray(j["pos"]))


@pytest.mark.parametrize("s,steps", [(S, 3), (28, 6)])
def test_prefill_then_decode_past_the_ring_wrap(models, s, steps):
    """Prefill of 40 tokens keeps the last 32 positions of each local layer
    in its ring; from 28 tokens the decode steps write past slot 31 and wrap.
    Logits, value and every layer's state (h, conv, ring k, v and pos)
    against ``rg_prefill`` / ``rg_decode_step``."""
    jbundle, jparams, bundle, params, tokens = models
    cfg = bundle.cfg
    prompt = tokens[:, :s]
    jout, jc = jbundle.prefill(jparams, {"tokens": jnp.asarray(prompt, jnp.int32)},
                               max_len=MAX_LEN, dtype=jnp.float32)
    out, tc = bundle.prefill(params, {"tokens": torch.from_numpy(prompt)},
                             max_len=MAX_LEN, dtype=torch.float32)
    _close(out.logits, jout.logits)
    _close(out.value, jout.value)
    _check_caches(cfg, tc, jc)
    assert tc["layers"][2]["k"].shape[1] == cfg.local_window   # min(max_len, window)

    for t in np.random.default_rng(2).integers(0, 277, (steps, B, 1)):
        jout, jc = jbundle.decode_step(jparams, jnp.asarray(t, jnp.int32), jc)
        out, tc = bundle.decode_step(params, torch.from_numpy(t), tc)
        assert out.logits.shape == (B, 1, 277)
        _close(out.logits, jout.logits)
        _close(out.value, jout.value)
    _check_caches(cfg, tc, jc)
    assert int(tc["index"]) == s + steps


def test_greedy_generate_tokens_equal_jax(models):
    jbundle, jparams, bundle, params, tokens = models
    want = jgreedy(jbundle, jparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
                   steps=8, max_len=MAX_LEN, dtype=jnp.float32)
    got = greedy_generate(bundle, params, {"tokens": torch.from_numpy(tokens)},
                          steps=8, max_len=MAX_LEN, dtype=torch.float32)
    assert got.dtype == torch.int32 and got.shape == (B, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bf16_cache_decode_stays_close(models):
    """The serving default: bf16 ring caches and conv states with fp32
    compute (h stays fp32). The port keeps the conv state in the cache dtype
    after a decode step, where the JAX model promotes it to fp32; the logits
    stay within bf16 tolerance of the JAX model's."""
    jbundle, jparams, bundle, params, tokens = models
    jout, jc = jbundle.prefill(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
                               max_len=MAX_LEN)
    out, tc = bundle.prefill(params, {"tokens": torch.from_numpy(tokens)}, max_len=MAX_LEN)
    assert tc["layers"][0][1].dtype == torch.bfloat16 and tc["layers"][0][0].dtype == torch.float32
    assert tc["layers"][2]["k"].dtype == torch.bfloat16
    t = np.full((B, 1), 3)
    for _ in range(2):
        jout, jc = jbundle.decode_step(jparams, jnp.asarray(t, jnp.int32), jc)
        out, tc = bundle.decode_step(params, torch.from_numpy(t), tc)
    assert tc["layers"][0][1].dtype == torch.bfloat16
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(jout.logits),
                               atol=5e-2, rtol=5e-2)


def test_init_cache_rings_and_states():
    cfg = smoke_config(ARCH)
    bundle = make_model(cfg)
    short = bundle.init_cache(2, 20, device="cpu")
    long = bundle.init_cache(2, 4096, device="cpu")
    assert short["layers"][2]["k"].shape == (2, 20, 1, 16)      # max_len < window
    assert long["layers"][2]["k"].shape == (2, 32, 1, 16)       # the window
    assert [tuple(t.shape) for t in long["layers"][0]] == [(2, 64), (2, 3, 64)]
    assert len(long["layers"]) == 5 and int(long["index"]) == 0
    with pytest.raises(ValueError, match="max_len"):
        bundle.prefill(bundle.init(0, device="cpu"), {"tokens": torch.zeros(1, 4).long()})


@pytest.mark.parametrize("override,match", [
    ({"norm": "layernorm"}, "layernorm"),
    ({"attn_softcap": 30.0}, "softcap"),
    ({"block_pattern": ("rglru", "global")}, "block kinds"),
])
def test_unported_parts_raise(override, match):
    with pytest.raises(NotImplementedError, match=match):
        make_model(smoke_config(ARCH).with_(**override))
