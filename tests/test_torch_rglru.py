"""The port's RG-LRU pieces against the JAX package on the same numpy inputs:
the scan (K4's plain version on the CPU) and its oracle, the recurrent
block in prefill and decode, and the gemma options RecurrentGemma brings
(the Lambda initialiser, the (1+scale) norm, the embedding scale and the
tanh GELU).

Tolerances: the scan 1e-5 (absolute and relative), as
tests/test_kernels.py:78-86 holds the Pallas kernel to ``rglru_ref``: the
loop and the associative scan multiply the same fp32 numbers in another
order. The block and the gemma pieces 1e-5 as well: one layer in fp32,
summation order only; a wrong gate, conv shift or erf GELU moves the block's
output by 1e-3 or more.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import smoke_config as jsmoke_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.nn import embed as jembed  # noqa: E402
from repro.nn import init as jinit  # noqa: E402
from repro.nn import mlp as jmlp  # noqa: E402
from repro.nn import norms as jnorms  # noqa: E402
from repro.nn import rglru as jrglru  # noqa: E402
from repro_torch.configs.registry import smoke_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rglru_scan as trglru_scan  # noqa: E402
from repro_torch.nn import embed, init, mlp, norms, rglru  # noqa: E402

TOL = 1e-5
ARCH = "recurrentgemma-2b"


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _scan_inputs(seed, b, s, w, h0=False):
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, w)))).astype(np.float32)
    bb = (rng.standard_normal((b, s, w)) * 0.1).astype(np.float32)
    h = rng.standard_normal((b, w)).astype(np.float32) if h0 else None
    return a.astype(np.float32), bb, h


@pytest.mark.parametrize("s,w,block_s", [(128, 64, 32), (256, 128, 64)])
def test_rglru_scan_plain_matches_pallas(s, w, block_s):
    """The sweep of tests/test_kernels.py::test_rglru_scan, with the Pallas
    kernel in interpret mode as that test runs it."""
    a, bb, _ = _scan_inputs(0, 2, s, w)
    want = jops.rglru_scan(jnp.asarray(a), jnp.asarray(bb), block_s=block_s)
    got, h_last = ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(bb))
    assert got.dtype == torch.float32 and got.shape == (2, s, w)
    _close(got, want)
    _close(h_last, np.asarray(want)[:, -1])


@pytest.mark.parametrize("b,s,w", [(2, 37, 50), (3, 1, 8), (1, 130, 64)])
def test_rglru_scan_plain_matches_ref_with_state(b, s, w):
    """An initial state in and the last state out, at ragged S and W,
    against ``repro.kernels.ref.rglru_ref``; and the port's oracle against
    JAX's."""
    a, bb, h0 = _scan_inputs(1, b, s, w, h0=True)
    want_y, want_h = jref.rglru_ref(jnp.asarray(a), jnp.asarray(bb), jnp.asarray(h0))
    ta, tb, th = (torch.from_numpy(x) for x in (a, bb, h0))
    got_y, got_h = ops.rglru_scan(ta, tb, h0=th)
    _close(got_y, want_y)
    _close(got_h, want_h)
    ry, rh = ref.rglru_ref(ta, tb, th)
    _close(ry, want_y)
    _close(rh, want_h)


def test_rglru_scan_out_dtype_rounds_each_step_once():
    """With a bf16 y the carry stays fp32: y is the fp32 sequence rounded,
    and the last state is the fp32 one."""
    a, bb, h0 = _scan_inputs(2, 2, 20, 16, h0=True)
    ta, tb, th = (torch.from_numpy(x) for x in (a, bb, h0))
    y32, h32 = ops.rglru_scan(ta, tb, h0=th)
    y16, h16 = ops.rglru_scan(ta, tb, h0=th, out_dtype=torch.bfloat16)
    assert y16.dtype == torch.bfloat16 and h16.dtype == torch.float32
    assert torch.equal(y16, y32.to(torch.bfloat16)) and torch.equal(h16, h32)


def _chunked_scan(a, b, h0, t, nc):
    """A plain mirror of K4's walk (csrc/rglru_scan.cu), for these tests
    only: S in tiles of nc chunks of t steps, steps past S the identity
    (a 1, b 0); each chunk walks from h = 0 for its pair (prod a, local h),
    the pairs fold in order from the tile's incoming h into each chunk's
    incoming h and the tile's outgoing one, and each chunk walks again from
    its incoming h to give y. Returns (y, h_last) in fp32."""
    bsz, s, w = a.shape
    pad = -s % (t * nc)
    a = torch.cat([a, a.new_ones(bsz, pad, w)], 1).reshape(bsz, -1, nc, t, w)
    b = torch.cat([b, b.new_zeros(bsz, pad, w)], 1).reshape(bsz, -1, nc, t, w)
    h = a.new_zeros(bsz, w) if h0 is None else h0
    tiles = []
    for ta, tb in zip(a.unbind(1), b.unbind(1)):      # (B, nc, t, W) each
        prod, local = ta.new_ones(bsz, nc, w), ta.new_zeros(bsz, nc, w)
        for u in range(t):
            prod, local = prod * ta[:, :, u], ta[:, :, u] * local + tb[:, :, u]
        starts = []
        for j in range(nc):
            starts.append(h)
            h = prod[:, j] * h + local[:, j]
        hc, ys = torch.stack(starts, 1), []
        for u in range(t):
            hc = ta[:, :, u] * hc + tb[:, :, u]
            ys.append(hc)
        tiles.append(torch.stack(ys, 2).reshape(bsz, nc * t, w))
    return torch.cat(tiles, 1)[:, :s], h


@pytest.mark.parametrize("b,s,w,t,nc,with_h0", [
    (2, 37, 5, 4, 3, True),      # ragged S over four tiles of three chunks
    (1, 1, 3, 4, 2, True),       # S 1
    (3, 6, 4, 8, 2, False),      # S shorter than one chunk
    (2, 100, 7, 8, 4, False),    # ragged S over four tiles
    (1, 129, 6, 16, 8, True),    # one step past a tile of 128
    (2, 64, 3, 1, 1, True),      # one step a chunk and a tile: the plain loop
])
def test_chunked_scan_matches_ref_and_jax_scan(b, s, w, t, nc, with_h0):
    """The chunk-and-carry algebra K4 runs, at ragged S, T and NC, against
    the sequential oracles (``ref.rglru_ref`` and JAX's) and against JAX's
    associative scan (``repro.nn.rglru.rglru``, on its own gates of a drawn
    x), within 1e-5 as the loop and the associative scan are held."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    p = {"gate_a": rng.standard_normal((w, w)).astype(np.float32) * w ** -0.5,
         "gate_x": rng.standard_normal((w, w)).astype(np.float32) * w ** -0.5,
         "ba": rng.standard_normal(w).astype(np.float32) * 0.1,
         "bx": rng.standard_normal(w).astype(np.float32) * 0.1,
         "lam": rng.standard_normal(w).astype(np.float32)}
    h0 = rng.standard_normal((b, w)).astype(np.float32) if with_h0 else None
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jh0 = None if h0 is None else jnp.asarray(h0)
    ja, jb = jrglru._gates(jp, jnp.asarray(x))
    want_y, want_h = jrglru.rglru(jp, jnp.asarray(x), jh0)
    ta, tb = torch.from_numpy(np.array(ja)), torch.from_numpy(np.array(jb))
    th0 = None if h0 is None else torch.from_numpy(h0)
    got_y, got_h = _chunked_scan(ta, tb, th0, t, nc)
    _close(got_y, want_y)
    _close(got_h, want_h)
    ry, rh = ref.rglru_ref(ta, tb, th0)
    _close(got_y, ry)
    _close(got_h, rh)
    jy, jh = jref.rglru_ref(ja, jb, jh0)
    _close(got_y, jy)
    _close(got_h, jh)


@pytest.mark.parametrize("t,nc", [(8, 8), (16, 8), (8, 4)])
@pytest.mark.parametrize("b,s,w", [(4, 512, 2560), (2, 4096, 256), (1, 2049, 96)])
def test_chunked_scan_at_kernel_plans(b, s, w, t, nc):
    """The mirror at chunks and tiles the kernel is built with (T 8, NC 8
    shipped; the others in tools/k4_plan_sweep.py), at the serving widths
    and at S over many tiles, ragged, against the plain version."""
    a, bb, h0 = _scan_inputs(11, b, s, w, h0=True)
    ta, tb, th = (torch.from_numpy(x) for x in (a, bb, h0))
    got_y, got_h = _chunked_scan(ta, tb, th, t, nc)
    want_y, want_h = ops.rglru_scan_plain(ta, tb, h0=th)
    scale = max(float(want_y.abs().max()), 1.0)
    torch.testing.assert_close(got_y, want_y, atol=TOL * scale, rtol=TOL)
    torch.testing.assert_close(got_h, want_h, atol=TOL * scale, rtol=TOL)


def _bwd_constant(name):
    cu = Path(trglru_scan.__file__).resolve().parent / "csrc" / "rglru_scan_bwd.cu"
    return int(re.search(rf"^constexpr int {name} = (\d+);", cu.read_text(), re.M).group(1))


def _chunked_scan_bwd(a, y, h0, dy, dh_last, t, nc):
    """A plain mirror of K4-bwd's walk (csrc/rglru_scan_bwd.cu), for these
    tests only: S in tiles of nc chunks of t steps, walked from the last
    tile; a chunk holds a_{s+1} (1 at or past S), dy_s (0 past S) and
    y_{s-1} (h0 at s = 0); each chunk walks down from g = 0 for its pair
    (prod a, local g), the pairs fold from the top chunk down from the
    tile's incoming g into each chunk's incoming g and the tile below's,
    and each chunk walks again from its incoming g to give db = g and
    da = g y_{s-1}. Returns (da, db, dh0 = a_0 g_0 or None)."""
    bsz, s, w = a.shape
    n = -(-s // (t * nc)) * t * nc
    h_init = a.new_zeros(bsz, 1, w) if h0 is None else h0[:, None]
    shape = (bsz, -1, nc, t, w)
    an = torch.cat([a[:, 1:], a.new_ones(bsz, n - s + 1, w)], 1).reshape(shape)
    dn = torch.cat([dy, dy.new_zeros(bsz, n - s, w)], 1).reshape(shape)
    yn = torch.cat([h_init, y[:, :-1], y.new_zeros(bsz, n - s, w)], 1).reshape(shape)
    g = a.new_zeros(bsz, w) if dh_last is None else dh_last
    da, db = [], []
    for k in reversed(range(an.shape[1])):
        ta, td = an[:, k], dn[:, k]                       # (B, nc, t, W)
        prod, local = ta.new_ones(bsz, nc, w), ta.new_zeros(bsz, nc, w)
        for u in reversed(range(t)):
            prod, local = prod * ta[:, :, u], ta[:, :, u] * local + td[:, :, u]
        starts = [None] * nc
        for j in reversed(range(nc)):
            starts[j] = g
            g = prod[:, j] * g + local[:, j]
        gc, gs = torch.stack(starts, 1), [None] * t
        for u in reversed(range(t)):
            gc = ta[:, :, u] * gc + td[:, :, u]
            gs[u] = gc
        gt = torch.stack(gs, 2)
        db.insert(0, gt.reshape(bsz, nc * t, w))
        da.insert(0, (gt * yn[:, k]).reshape(bsz, nc * t, w))
    return (torch.cat(da, 1)[:, :s], torch.cat(db, 1)[:, :s],
            None if h0 is None else a[:, 0] * g)


def _jax_scan_vjp(monkeypatch, a, b, h0, dy, dh_last):
    """jax.vjp of the JAX package's associative scan (``repro.nn.rglru.rglru``)
    in a and b themselves: its gates are bypassed for the call."""
    monkeypatch.setattr(jrglru, "_gates", lambda p, x: (p["a"], x))
    ins = tuple(jnp.asarray(x) for x in (a, b) + (() if h0 is None else (h0,)))
    dh = np.zeros_like(a[:, 0]) if dh_last is None else dh_last

    @jax.jit   # one compiled program: faster on the CPU than the vjp's ops one by one
    def grads(ins, cot):
        return jax.vjp(lambda a, b, *h: jrglru.rglru({"a": a}, b, *h), *ins)[1](cot)
    return grads(ins, (jnp.asarray(dy), jnp.asarray(dh)))


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,w", [
    (2, 150, 40),     # ragged S over three tiles
    (1, 1, 37),       # S 1, B 1
    (2, 64, 5),       # one whole tile, W under a strip
    (1, 300, 7),      # B 1, ragged S over five tiles
])
def test_chunked_scan_bwd_matches_plain_and_jax_vjp(monkeypatch, b, s, w, with_h0, with_dh):
    """K4-bwd's reverse chunk-and-carry walk at the kernel's T and NC (read
    from the .cu) against ``ops.rglru_scan_bwd_plain`` and jax.vjp of the
    associative scan, within 1e-5 of each gradient's max."""
    t, nc = _bwd_constant("T"), _bwd_constant("NC")
    rng = np.random.default_rng(12)
    a, bb, h0 = _scan_inputs(13, b, s, w, h0=with_h0)
    dy = rng.standard_normal((b, s, w)).astype(np.float32)
    dh = rng.standard_normal((b, w)).astype(np.float32) if with_dh else None
    ta, tb = torch.from_numpy(a), torch.from_numpy(bb)
    th0 = None if h0 is None else torch.from_numpy(h0)
    tdh = None if dh is None else torch.from_numpy(dh)
    y, _ = ops.rglru_scan_plain(ta, tb, h0=th0)
    got = _chunked_scan_bwd(ta, y, th0, torch.from_numpy(dy), tdh, t, nc)
    plain = ops.rglru_scan_bwd_plain(ta, y, th0, torch.from_numpy(dy), tdh)
    jgrads = _jax_scan_vjp(monkeypatch, a, bb, h0, dy, dh)
    assert (got[2] is None) == (h0 is None)
    got, plain = [g for g in got if g is not None], [p for p in plain if p is not None]
    for g, p, j in zip(got, plain, jgrads):
        scale = max(float(p.abs().max()), 1e-30)
        torch.testing.assert_close(g, p, atol=TOL * scale, rtol=TOL)
        j = np.asarray(j, np.float32)
        np.testing.assert_allclose(g.numpy(), j, atol=TOL * max(float(np.abs(j).max()), 1e-30),
                                   rtol=TOL)


def test_rglru_kernel_wrapper_refuses_cpu_and_bad_inputs():
    """The CUDA wrapper never falls back: CPU tensors are an error there."""
    a = torch.rand(2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        trglru_scan.rglru_scan(a, a)
    with pytest.raises(ValueError, match="B,S,W"):
        trglru_scan.rglru_scan(a, a[:, :4])
    with pytest.raises(ValueError, match="h0"):
        trglru_scan.rglru_scan(a, a, h0=torch.zeros(2, 8))
    with pytest.raises(TypeError, match="fp32"):
        trglru_scan.rglru_scan(a.bfloat16(), a.bfloat16())
    with pytest.raises(TypeError, match="out_dtype"):
        trglru_scan.rglru_scan(a, a, out_dtype=torch.float16)
    assert ops.launch_counts()["rglru_scan"] == 0


# ------------------------------ the block ---------------------------------

@pytest.fixture(scope="module")
def block():
    """The recurrent block's params, numpy-drawn, in both packages' layouts."""
    cfg, jcfg = smoke_config(ARCH), jsmoke_config(ARCH)
    d, w = cfg.d_model, cfg.lru_width
    rng = np.random.default_rng(3)
    f = lambda *sh, s=1.0: (rng.standard_normal(sh) * s).astype(np.float32)
    lam = np.array(jinit.lru_a_init()(jax.random.PRNGKey(0), (w,)))   # writable
    arrs = {"wx": f(d, w, s=d ** -0.5), "wy": f(d, w, s=d ** -0.5),
            "conv": {"w": f(4, w, s=0.5), "b": f(w, s=0.1)},
            "gate_a": f(w, w, s=w ** -0.5), "ba": f(w, s=0.1),
            "gate_x": f(w, w, s=w ** -0.5), "bx": f(w, s=0.1),
            "lam": lam, "wo": f(w, d, s=w ** -0.5)}
    p = rglru.RGLRU(cfg, gen=torch.Generator().manual_seed(0))
    for k, v in arrs.items():
        if k == "conv":
            p.conv.w.data, p.conv.b.data = torch.from_numpy(v["w"]), torch.from_numpy(v["b"])
        else:
            getattr(p, k).data = torch.from_numpy(v)
    jp = jax.tree.map(jnp.asarray, arrs)
    return cfg, jcfg, p, jp


@pytest.mark.parametrize("s", [2, 11])
def test_rglru_block_prefill_then_decode_matches_jax(block, s):
    """Prefill of s steps (2 is shorter than the conv's 3 kept inputs) from
    the zero state, then three decode steps from the state it hands over:
    the block's output, the fp32 h and the conv state, against
    ``repro.nn.rglru.rglru_block``."""
    cfg, jcfg, p, jp = block
    rng = np.random.default_rng(4)
    u = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    th, tconv = rglru.rglru_state_init(cfg, 2, torch.float32, "cpu")
    jh, jconv = jrglru.rglru_state_init(jcfg, 2, jnp.float32)
    got, (th, tconv) = rglru.rglru_block(cfg, p, torch.from_numpy(u), h0=th, conv_state=tconv)
    want, (jh, jconv) = jrglru.rglru_block(jcfg, jp, jnp.asarray(u), h0=jh, conv_state=jconv)
    _close(got, want)
    _close(th, jh)
    _close(tconv, jconv)
    assert th.dtype == torch.float32 and tuple(tconv.shape) == (2, 3, cfg.lru_width)
    if s < 3:
        assert bool((tconv[:, :3 - s] == 0).all())
    for t in range(3):
        ut = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        got, (th, tconv) = rglru.rglru_block(cfg, p, torch.from_numpy(ut), h0=th,
                                             conv_state=tconv, decode=True)
        want, (jh, jconv) = jrglru.rglru_block(jcfg, jp, jnp.asarray(ut), h0=jh,
                                               conv_state=jconv, decode=True)
        _close(got, want)
        _close(th, jh)
        _close(tconv, jconv)


def test_rglru_block_without_state_matches_jax(block):
    """The forward (training) call: no h0 and no conv state."""
    cfg, jcfg, p, jp = block
    u = np.random.default_rng(5).standard_normal((3, 9, cfg.d_model)).astype(np.float32)
    got, (th, tconv) = rglru.rglru_block(cfg, p, torch.from_numpy(u))
    want, (jh, _) = jrglru.rglru_block(jcfg, jp, jnp.asarray(u))
    _close(got, want)
    _close(th, jh)
    assert tconv is None


# --------------------------- the gemma pieces -----------------------------

def test_lru_a_init_draws_the_jax_range():
    """a = exp(-8 softplus(Lambda)) has radius in [0.9, 0.999], uniform in
    its square, as ``repro.nn.init.lru_a_init``."""
    lam = init.lru_a_init()(torch.Generator().manual_seed(0), (4000,), torch.float32, "cpu")
    a = torch.exp(-8.0 * torch.nn.functional.softplus(lam))
    assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6
    jlam = jinit.lru_a_init()(jax.random.PRNGKey(0), (4000,))
    ja = jnp.exp(-8.0 * jax.nn.softplus(jlam))
    assert abs(float((a ** 2).mean()) - float((ja ** 2).mean())) < 0.003
    assert abs(float((a ** 2).mean()) - (0.9 ** 2 + 0.999 ** 2) / 2) < 0.003


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemma_norm_scales_by_one_plus_scale(dtype):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    scale = (rng.standard_normal(32) * 0.3).astype(np.float32)
    p = norms.Norm(32, gemma_scale=True)
    assert bool((p.scale == 0).all())          # gemma's scale starts at zeros
    p.scale.data = torch.from_numpy(scale)
    got = norms.apply_norm(p, torch.from_numpy(x).to(getattr(torch, dtype)), 1e-6,
                           gemma_scale=True)
    want = jnorms.apply_norm({"scale": jnp.asarray(scale)},
                             jnp.asarray(x).astype(getattr(jnp, dtype)), eps=1e-6,
                             gemma_scale=True)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL if dtype == "float32" else 1e-2, rtol=TOL)


def test_embed_scale_by_dim_and_tied_unembed():
    cfg, jcfg = smoke_config(ARCH), jsmoke_config(ARCH)
    assert cfg.embed_scale and cfg.tie_embeddings
    p = embed.Embed(cfg, gen=torch.Generator().manual_seed(0))
    jp = {"table": jnp.asarray(p.table.numpy())}
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 6))
    x = embed.embed(cfg, p, torch.from_numpy(tokens), scale_by_dim=True)
    _close(x, jembed.embed(jcfg, jp, jnp.asarray(tokens), scale_by_dim=True))
    _close(x / np.sqrt(cfg.d_model), jembed.embed(jcfg, jp, jnp.asarray(tokens)))
    _close(embed.unembed(cfg, p, x), jembed.unembed(jcfg, jp, jnp.asarray(x.numpy())), tol=1e-4)


@pytest.mark.parametrize("act", ["gelu", "gelu_tanh"])
def test_gated_gelu_mlp_is_the_tanh_form(act):
    """Both names take jax.nn.gelu's default, the tanh approximation; the
    erf form would differ by about 1e-3 here."""
    d, ff = 16, 40
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((2, 3, d)) * 2).astype(np.float32)
    w = {k: (rng.standard_normal(s) * 0.5).astype(np.float32)
         for k, s in (("wi", (d, ff)), ("wg", (d, ff)), ("wo", (ff, d)))}
    p = mlp.MLP(d, ff, gen=torch.Generator().manual_seed(0))
    for k, v in w.items():
        getattr(p, k).data = torch.from_numpy(v)
    want = jmlp.mlp({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x), act)
    tx = torch.from_numpy(x)
    _close(mlp.mlp(p, tx, act), want)
    erf = (torch.nn.functional.gelu(tx @ p.wi) * (tx @ p.wg)) @ p.wo
    assert float((erf - torch.from_numpy(np.array(want))).abs().max()) > 1e-4
