"""The port's dense LM against the JAX package at smoke_config("qwen3-14b"),
on params converted by ``params_from_jax``, in fp32 on the CPU.

Tolerance 1e-4 (absolute and relative): both sides compute in fp32, so
what differs is the order of summation in the products (XLA's dots against
PyTorch's BLAS) and the masking constants (-2e38 additive in the JAX model,
-1e30 in the kernels' plain versions), which give the same zero weight to
every masked key. Over four layers that stays near 1e-6; 1e-4 leaves room
without hiding a wrong mask, rope or norm, which each move logits by 1e-2
or more.
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
ARCH = "qwen3-14b"
B, S, MAX_LEN = 2, 12, 32


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = jsmoke_config(ARCH), smoke_config(ARCH)
    assert cfg == cfg.with_(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    jbundle = jmake_model(jcfg)
    jparams = jbundle.init(jax.random.PRNGKey(0))
    bundle = make_model(cfg)
    params = bundle.init(0, device="cpu")
    params.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    return jbundle, jparams, bundle, params, tokens


def _close(t, j):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               atol=TOL, rtol=TOL)


def test_convert_covers_every_param(models):
    _, jparams, _, params, _ = models
    n_jax = sum(a.size for a in jax.tree.leaves(jparams))
    assert sum(p.numel() for p in params.parameters()) == n_jax
    sd = params_from_jax(params_cfg := smoke_config(ARCH),
                         jax.tree.map(np.asarray, jparams))
    assert set(sd) == set(params.state_dict())
    assert len(params.blocks) == params_cfg.num_layers


def test_forward_logits_and_value(models):
    jbundle, jparams, bundle, params, tokens = models
    want = jbundle.forward(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    got = bundle.forward(params, {"tokens": torch.from_numpy(tokens)})
    assert got.logits.shape == (B, S, 277) and got.logits.dtype == torch.float32
    _close(got.logits, want.logits)
    _close(got.value, want.value)


def _jcache(jc):
    main = jc["main"][0]
    return {k: np.asarray(main[k]) for k in ("k", "v", "pos")}, int(jc["index"])


def _tcache(tc):
    layers = tc["layers"]
    stacked = {k: torch.stack([c[k] for c in layers]) for k in ("k", "v")}
    # the JAX cache stacks `pos` per layer too
    stacked["pos"] = torch.stack([c["pos"] for c in layers])
    return stacked, int(tc["index"])


def test_prefill_then_three_decode_steps(models):
    jbundle, jparams, bundle, params, tokens = models
    jout, jc = jbundle.prefill(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
                               max_len=MAX_LEN, dtype=jnp.float32)
    out, tc = bundle.prefill(params, {"tokens": torch.from_numpy(tokens)},
                             max_len=MAX_LEN, dtype=torch.float32)
    _close(out.logits, jout.logits)
    _close(out.value, jout.value)
    (jkv, jidx), (tkv, tidx) = _jcache(jc), _tcache(tc)
    assert tidx == jidx == S
    for key in ("k", "v"):
        _close(tkv[key], jkv[key])
    np.testing.assert_array_equal(tkv["pos"].numpy(), jkv["pos"])

    steps = np.random.default_rng(2).integers(0, 277, (3, B, 1))
    for t in steps:
        jout, jc = jbundle.decode_step(jparams, jnp.asarray(t, jnp.int32), jc)
        out, tc = bundle.decode_step(params, torch.from_numpy(t), tc)
        assert out.logits.shape == (B, 1, 277)
        _close(out.logits, jout.logits)
        _close(out.value, jout.value)
    (jkv, jidx), (tkv, tidx) = _jcache(jc), _tcache(tc)
    assert tidx == jidx == S + 3
    for key in ("k", "v"):
        _close(tkv[key], jkv[key])
    np.testing.assert_array_equal(tkv["pos"].numpy(), jkv["pos"])


def test_greedy_generate_tokens_equal_jax(models):
    jbundle, jparams, bundle, params, tokens = models
    want = jgreedy(jbundle, jparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
                   steps=8, max_len=MAX_LEN, dtype=jnp.float32)
    got = greedy_generate(bundle, params, {"tokens": torch.from_numpy(tokens)},
                          steps=8, max_len=MAX_LEN, dtype=torch.float32)
    assert got.dtype == torch.int32 and got.shape == (B, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bf16_cache_decode_stays_close(models):
    """The serving default: a bf16 cache with fp32 compute. The port rounds
    q to the cache dtype before K2; the result stays within bf16 tolerance
    of the JAX model's."""
    jbundle, jparams, bundle, params, tokens = models
    jout, jc = jbundle.prefill(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
                               max_len=MAX_LEN)
    out, tc = bundle.prefill(params, {"tokens": torch.from_numpy(tokens)},
                             max_len=MAX_LEN)
    assert tc["layers"][0]["k"].dtype == torch.bfloat16
    t = np.full((B, 1), 3)
    jout, _ = jbundle.decode_step(jparams, jnp.asarray(t, jnp.int32), jc)
    out, _ = bundle.decode_step(params, torch.from_numpy(t), tc)
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(jout.logits),
                               atol=5e-2, rtol=5e-2)


# the LM parts slice 18 ported, each on qwen3's reduced config: an MLA
# attention, an MTP head, a first dense layer, num_experts on a dense
# family (inert, as in the reference), and an MoE family
PORTED_PARTS = [
    {"mla": True, "q_lora_rank": 32, "kv_lora_rank": 16, "qk_nope_head_dim": 16,
     "qk_rope_head_dim": 8, "v_head_dim": 16},
    {"mtp_depth": 1},
    {"first_dense_layers": 1},
    {"num_experts": 4},
    {"family": "moe", "num_experts": 4, "num_experts_per_tok": 2, "moe_d_ff": 32},
]


@pytest.mark.parametrize("override", PORTED_PARTS,
                         ids=["MLA", "MTP", "first dense layers", "MoE inert", "MoE"])
def test_ported_parts_build_and_match_jax(override):
    """Each part the LM used to refuse builds, converts and gives the JAX
    model's logits, router loss and MTP logits."""
    jcfg, cfg = jsmoke_config(ARCH).with_(**override), smoke_config(ARCH).with_(**override)
    jbundle = jmake_model(jcfg)
    jparams = jbundle.init(jax.random.PRNGKey(0))
    bundle = make_model(cfg)
    params = bundle.init(0, device="cpu")
    params.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    want = jbundle.forward(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    got = bundle.forward(params, {"tokens": torch.from_numpy(tokens)})
    _close(got.logits, want.logits)
    _close(got.aux_loss, want.aux_loss)
    assert (got.mtp_logits is None) == (want.mtp_logits is None) == (not cfg.mtp_depth)
    if cfg.mtp_depth:
        _close(got.mtp_logits, want.mtp_logits)


@pytest.mark.parametrize("override,match", [
    ({"tp": 16}, "padded heads"),
    ({"act": "sigmoid"}, "activation 'sigmoid'"),
    pytest.param({"family": "encdec", "enc_layers": 2, "dec_layers": 2, "tp": 16},
                 "padded heads", id="override2-encdec"),
])
def test_unported_parts_raise(override, match):
    """Unknown activations raise. Padded heads (tp > 1) are ported in the LM
    and the encoder-decoder: they build with ``cfg.padded_heads`` query
    heads in wq, bq and wo and the vocab padded to 256 (their parity with
    the reference is in tests/test_torch_sharding.py)."""
    cfg = smoke_config(ARCH).with_(**override)
    if match == "padded heads":
        params = make_model(cfg).init(0, device="cpu")
        attn = (params.dec[0].attn if cfg.family == "encdec" else params.blocks[0].attn)
        assert cfg.padded_heads == 16 != cfg.num_heads
        assert attn.wq.shape[1] == attn.wo.shape[0] == cfg.padded_heads
        assert params.embed.table.shape[0] == cfg.padded_vocab == 512
        return
    with pytest.raises(NotImplementedError, match=match):
        make_model(cfg)


def test_unported_archs_and_caches_raise():
    """The dense and MoE families are ported (gemma2's local layers, MLA,
    MTP and DeepSeek's first dense layers included), and so is every arch of
    the reference: the registry refuses only an unknown arch; the LM refuses
    only unknown activations (padded heads are ported), and the attention
    refuses a cache of a kind that keeps none (the encoder's "bidir")."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.lm import check_supported
    from repro_torch.nn.attention import make_cache
    with pytest.raises(KeyError, match="unknown arch 'no-such-arch'"):
        get_config("no-such-arch")
    for arch in ("gemma2-9b", "qwen3-moe-30b-a3b", "deepseek-v3-671b"):
        check_supported(get_config(arch))
    check_supported(smoke_config(ARCH).with_(mtp_depth=1, first_dense_layers=1))
    check_supported(smoke_config(ARCH).with_(tp=16))
    with pytest.raises(NotImplementedError, match=r"not ported yet: activation 'sigmoid'$"):
        check_supported(smoke_config(ARCH).with_(tp=16, act="sigmoid"))
    with pytest.raises(NotImplementedError, match="not ported"):
        make_cache(smoke_config(ARCH), 1, 8, kind="bidir", device="cpu")


def test_sharded_serving_on_one_rank_mesh_matches_jax_greedy():
    """qwen3-14b's reduced config at tp 4 with 6 query heads over 2 kv heads
    (8 padded heads, vocab 512), its params converted from the reference
    and laid out as DTensors on a one-rank mesh under the decode rules
    (``launch.mesh.single_device_mesh``, ``launch.specs.rules_for``):
    greedy decoding under ``sharding_ctx`` gives the reference's greedy
    tokens and the plain path's, and the cache it makes is DTensors."""
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.launch.specs import rules_for
    from repro_torch.sharding.ctx import sharding_ctx
    from repro_torch.sharding.param import distribute_module
    pad = dict(num_heads=6, num_kv_heads=2, tp=4)
    jcfg, cfg = jsmoke_config(ARCH).with_(**pad), smoke_config(ARCH).with_(**pad)
    jbundle, bundle = jmake_model(jcfg), make_model(cfg)
    jparams = jbundle.init(jax.random.PRNGKey(0))
    params = bundle.init(0, device="cpu")
    params.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S))
    want = np.asarray(jgreedy(jbundle, jparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
                              steps=6, max_len=MAX_LEN, dtype=jnp.float32))
    plain = greedy_generate(bundle, params, {"tokens": torch.from_numpy(tokens)}, steps=6,
                            max_len=MAX_LEN, dtype=torch.float32)
    mesh = single_device_mesh("cpu")
    rules = rules_for(cfg, mesh, "decode")
    distribute_module(params, mesh, rules)
    with sharding_ctx(mesh, rules):
        got = greedy_generate(bundle, params, {"tokens": torch.from_numpy(tokens)}, steps=6,
                              max_len=MAX_LEN, dtype=torch.float32)
        cache = bundle.init_cache(B, MAX_LEN, torch.float32, device="cpu")
    assert type(cache["layers"][0]["k"]).__name__ == "DTensor"
    np.testing.assert_array_equal(plain.numpy(), want)
    assert torch.equal(got, plain)


def test_seq_sharded_decode_on_one_rank_mesh_is_bit_equal():
    """The reference's decode layout on one rank: a (1, 1) ("data",
    "model") mesh maps ``act_kv_seq`` to "model", so every decode layer
    takes the sequence-sharded branch (K2's plain version with the
    log-sum-exp, then the combine), which on one rank weighs by exp(0) and
    divides by 1: the prefill and decode logits of the reduced qwen3-14b at
    tp 4, bf16, equal those under ``single_device_mesh``'s ("data",), bit
    for bit, and its cache is sharded on its sequence over "model"."""
    from repro_torch.launch.mesh import make_mesh, single_device_mesh
    from repro_torch.launch.specs import rules_for
    from repro_torch.sharding.ctx import sharding_ctx
    from repro_torch.sharding.param import distribute_module
    cfg = smoke_config(ARCH).with_(num_heads=6, num_kv_heads=2, tp=4)
    bundle = make_model(cfg)
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    feed = torch.from_numpy(rng.integers(0, cfg.vocab_size, (5, B, 1)))
    runs = {}
    for name in ("data", "data_model"):
        mesh = single_device_mesh("cpu") if name == "data" else \
            make_mesh((1, 1), ("data", "model"))
        rules = rules_for(cfg, mesh, "decode")
        params = bundle.init(0, device="cpu", dtype=torch.bfloat16)
        distribute_module(params, mesh, rules)
        with torch.no_grad(), sharding_ctx(mesh, rules):
            out, cache = bundle.prefill(params, {"tokens": tokens}, MAX_LEN, torch.bfloat16)
            logits = [out.logits]
            for t in feed:
                out, cache = bundle.decode_step(params, t, cache)
                logits.append(out.logits)
        runs[name] = ([x.full_tensor() for x in logits], rules["act_kv_seq"],
                      str(tuple(cache["layers"][0]["k"].placements)))
    assert runs["data"][1:] == ((), "(Shard(dim=0),)")
    assert runs["data_model"][1:] == (("model",), "(Shard(dim=0), Shard(dim=1))")
    for a, b in zip(runs["data"][0], runs["data_model"][0]):
        assert torch.equal(a, b)
