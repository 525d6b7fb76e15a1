"""The port's SSD scan (K3's plain version on the CPU), its oracle, the
Mamba2 layer pieces around it, against the JAX package on the same numpy
inputs.

Tolerances follow tests/test_kernels.py:73-75: fp32 atol 3e-5 * max|y_ref|
(at least 3e-5), rtol 1e-4 — the chunked form and the recurrence sum in
different orders, and exp of a cumulative sum carries its rounding. The
bf16 case holds the port to JAX's own bf16 chunked scan at 2e-2 of
max|y_ref|, bf16's resolution: both contract C·Bᵀ and C·S_prev in bf16.
An emulation of K3's tensor-core route (its chunk walk and its bf16
roundings) is held to the same references: y at 2e-2 of max|y_ref|, the
final state at 3e-5 of max|state_ref|, the bound the card's check holds the
kernel to.
"""

import re
from pathlib import Path


import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.nn import conv as jconv  # noqa: E402
from repro.nn import ssd as jssd  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.nn import conv, init, ssd  # noqa: E402


def _inputs(seed, b, s, h, p, n, g, dtype=np.float32, h0=False):
    """numpy x, dt (post-softplus), a (negative), b, c (G groups), h0."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    out = dict(x=f(b, s, h, p) * 0.5, dt=np.log1p(np.exp(f(b, s, h))),
               a=-np.exp(f(h) * 0.3), b=f(b, s, g, n) * 0.3, c=f(b, s, g, n) * 0.3)
    out["h0"] = f(b, h, p, n) * 0.2 if h0 else None
    return out


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a).astype(dtype)


def _close(got, want, scale_of=None, atol=3e-5, rtol=1e-4):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(np.asarray(scale_of if scale_of is not None else want,
                                        np.float32)).max()), 1.0)
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol * scale, rtol=rtol)


@pytest.mark.parametrize("s,p,n,chunk", [(128, 16, 32, 32), (256, 32, 16, 64)])
def test_ssd_scan_plain_matches_pallas(s, p, n, chunk):
    """The sweep of tests/test_kernels.py:63-75, head-expanded b and c
    (G == H, the JAX wrapper's layout), through the Pallas kernel in
    interpret mode."""
    b, h = 2, 3
    d = _inputs(0, b, s, h, p, n, h)
    want = jops.ssd_scan(*(_j(d[k]) for k in ("x", "dt", "a", "b", "c")), chunk=chunk)
    got = ops.ssd_scan(*(_t(d[k]) for k in ("x", "dt", "a", "b", "c")), chunk=chunk)
    assert got.shape == (b, s, h, p) and got.dtype == torch.float32
    yref, _ = jref.ssd_ref(*(_j(d[k]) for k in ("x", "dt", "a", "b", "c")))
    _close(got, want, scale_of=yref)
    _close(got, yref)


@pytest.mark.parametrize("s,g,chunk", [(200, 2, 64), (37, 1, 16), (9, 4, 16)])
def test_ssd_scan_plain_matches_ref_with_state(s, g, chunk):
    """Ragged S (no chunk divides it, and 9 < one chunk), G < H groups read
    unexpanded, a nonzero h0, and the final state, against the sequential
    oracle on head-expanded b and c."""
    b, h, p, n = 2, 4, 8, 16
    d = _inputs(1, b, s, h, p, n, g, h0=True)
    rep = lambda a: jnp.repeat(_j(a), h // g, axis=2)
    yref, sref = jref.ssd_ref(_j(d["x"]), _j(d["dt"]), _j(d["a"]), rep(d["b"]), rep(d["c"]),
                              h0=_j(d["h0"]))
    y, st = ops.ssd_scan(*(_t(d[k]) for k in ("x", "dt", "a", "b", "c")), chunk=chunk,
                         h0=_t(d["h0"]), return_state=True)
    assert st.dtype == torch.float32 and st.shape == (b, h, p, n)
    _close(y, yref)
    _close(st, sref)


def test_port_ssd_ref_matches_jax_ref():
    b, s, h, p, n = 2, 23, 3, 4, 8
    d = _inputs(2, b, s, h, p, n, h, h0=True)
    keys = ("x", "dt", "a", "b", "c")
    yj, sj = jref.ssd_ref(*(_j(d[k]) for k in keys), h0=_j(d["h0"]))
    yt, st = ref.ssd_ref(*(_t(d[k]) for k in keys), h0=_t(d["h0"]))
    _close(yt, yj, atol=1e-5, rtol=1e-5)
    _close(st, sj, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_matches_jax(dtype):
    """The layer-level call (``nn.ssd.ssd_chunked``) against the JAX
    package's, in the model's dtypes: x, b, c in `dtype`, dt, a and the
    state in fp32."""
    b, s, h, p, n, g, chunk = 2, 40, 4, 8, 16, 2, 16
    d = _inputs(3, b, s, h, p, n, g, h0=True)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jy, js = jssd.ssd_chunked(_j(d["x"], jd), _j(d["dt"]), _j(d["a"]), _j(d["b"], jd),
                              _j(d["c"], jd), chunk, h0=_j(d["h0"]))
    ty, ts = ssd.ssd_chunked(_t(d["x"], td), _t(d["dt"]), _t(d["a"]), _t(d["b"], td),
                             _t(d["c"], td), chunk, h0=_t(d["h0"]))
    assert ty.dtype == td and ts.dtype == torch.float32
    tol = 3e-5 if dtype == "float32" else 2e-2
    _close(ty, jy, atol=tol, rtol=1e-4 if dtype == "float32" else tol)
    _close(ts, js, atol=tol, rtol=1e-4 if dtype == "float32" else tol)


def test_ssd_scan_returns_y_alone_by_default():
    d = _inputs(4, 1, 20, 2, 4, 8, 1)
    args = [_t(d[k]) for k in ("x", "dt", "a", "b", "c")]
    y = ops.ssd_scan(*args, chunk=8)
    y2, st = ops.ssd_scan(*args, chunk=16, return_state=True)
    assert isinstance(y, torch.Tensor) and st.shape == (1, 2, 4, 8)
    torch.testing.assert_close(y, y2, atol=1e-5, rtol=1e-5)   # any chunk, one result


def test_ssd_kernel_wrapper_refuses_cpu_and_bad_shapes():
    """The CUDA wrapper never falls back: CPU tensors are an error there."""
    d = _inputs(5, 1, 8, 2, 4, 8, 1)
    args = [_t(d[k]) for k in ("x", "dt", "a", "b", "c")]
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_scan(*args)
    with pytest.raises(ValueError, match="do not match"):
        tssd.ssd_scan(args[0], args[1], args[2], torch.zeros(1, 8, 3, 8), torch.zeros(1, 8, 3, 8))
    with pytest.raises(ValueError, match="state size"):
        tssd.ssd_scan(args[0], args[1], args[2], torch.zeros(1, 8, 1, 256),
                      torch.zeros(1, 8, 1, 256))
    with pytest.raises(TypeError, match="fp32"):
        tssd.ssd_scan(args[0], args[1].double(), *args[2:])
    assert ops.launch_counts()["ssd_scan"] == 0


def _wgmma_walk(x, dt, a, b, c, h0=None, halves=2):
    """K3's tensor-core route as a chunk walk, one (batch, head) at a time:
    chunks of 64 steps, the ragged tail read as zeros (dt 0 past S); cs
    scanned in fp32; C·Bᵀ of the bf16 inputs accumulated in fp32; the decay
    masked to s <= t before exp; M rounded to bf16 before M·X; y starting
    from exp(cs_t) C·S_prevᵀ with S_prev rounded to bf16; the state kept in
    fp32, scaled by exp(cs_L) and updated by vᵀB with v = w x split into
    `halves` bf16 parts, largest first. x, b, c bf16 (B,S,H,P), (B,S,G,N);
    returns (y bf16, state fp32)."""
    bsz, s, h, p = x.shape
    g, n, L = b.shape[2], b.shape[3], 64
    pad = -s % L
    rnd = lambda t: t.to(torch.bfloat16).float()
    xf, bf, cf = (torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad)) for t in (x, b, c))
    dtf = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad))
    causal = torch.ones(L, L, dtype=torch.bool).tril()
    y = torch.zeros(bsz, s + pad, h, p)
    state = torch.zeros(bsz, h, p, n) if h0 is None else h0.float().clone()
    for bi in range(bsz):
        for hi in range(h):
            gi = hi // (h // g)
            st = state[bi, hi]
            for t0 in range(0, s + pad, L):
                rows = slice(t0, t0 + L)
                xs, bs, cs_ = xf[bi, rows, hi], bf[bi, rows, gi], cf[bi, rows, gi]
                d = dtf[bi, rows, hi]
                cum = torch.cumsum(d * a[hi], 0)
                decay = torch.where(causal, cum[:, None] - cum[None, :], -torch.inf)
                m = torch.where(causal, (cs_ @ bs.T) * torch.exp(decay) * d[None], 0.0)
                y[bi, rows, hi] = rnd(m) @ xs + torch.exp(cum)[:, None] * (cs_ @ rnd(st).T)
                v = (torch.exp(cum[-1] - cum) * d)[:, None] * xs        # (L, P)
                upd = torch.zeros(p, n)
                for _ in range(halves):
                    part = rnd(v)
                    upd += part.T @ bs
                    v = v - part
                st = torch.exp(cum[-1]) * st + upd
            state[bi, hi] = st
    return y[:, :s].to(torch.bfloat16), state


@pytest.mark.parametrize("s,g,n,with_h0", [
    (64, 1, 128, False),     # one chunk: the Pallas kernel in interpret mode
    (128, 2, 64, False),     # two chunks, G < H, N 64: the Pallas kernel
    (64, 2, 128, True),
    (200, 1, 128, True),     # ragged S over four chunks
    (200, 2, 128, False),
    (37, 1, 128, False),     # under one chunk
    (37, 2, 64, True),
])
def test_ssd_wgmma_walk_matches_pallas(s, g, n, with_h0):
    """The tensor-core route's design (64-step chunks, C·Bᵀ from bf16 in
    fp32, the mask before exp, M and S_prev rounded to bf16, the state
    update in hi + lo bf16 halves, the state in fp32) against the JAX
    package: y against the Pallas kernel in interpret mode (head-expanded b
    and c, no initial state) where S is a multiple of its chunk, else
    against ``ssd_chunked`` in bf16; y and the final state against the
    sequential oracle ``ssd_ref``."""
    b, h, p = 2, 4, 64
    d = _inputs(7, b, s, h, p, n, g, h0=with_h0)
    keys = ("x", "dt", "a", "b", "c")
    bf = {k: _t(d[k], torch.bfloat16) if k in ("x", "b", "c") else _t(d[k]) for k in keys}
    got_y, got_s = _wgmma_walk(*(bf[k] for k in keys), h0=_t(d["h0"]))
    assert got_y.dtype == torch.bfloat16 and got_s.shape == (b, h, p, n)
    jb = {k: _j(bf[k].float().numpy(), jnp.bfloat16) if k in ("x", "b", "c") else _j(d[k])
          for k in keys}
    rep = lambda t: jnp.repeat(t, h // g, axis=2)
    yref, sref = jref.ssd_ref(jb["x"], jb["dt"], jb["a"], rep(jb["b"]), rep(jb["c"]),
                              h0=_j(d["h0"]))
    if s % 64 == 0 and not with_h0:
        want = jops.ssd_scan(jb["x"], jb["dt"], jb["a"], rep(jb["b"]), rep(jb["c"]), chunk=64)
    else:
        want, _ = jax.jit(jssd.ssd_chunked, static_argnums=5)(
            jb["x"], jb["dt"], jb["a"], jb["b"], jb["c"], 64, h0=_j(d["h0"]))
    _close(got_y, want, scale_of=yref, atol=2e-2, rtol=2e-2)
    _close(got_y, yref, atol=2e-2, rtol=2e-2)
    _close(got_s, sref, atol=3e-5, rtol=0)


def test_ssd_wgmma_walk_needs_the_low_half():
    """The state's 3e-5 bound is what the hi + lo split buys: with v in one
    bf16 part the walk's state misses it."""
    d = _inputs(7, 1, 128, 2, 64, 128, 1, h0=True)
    keys = ("x", "dt", "a", "b", "c")
    bf = {k: _t(d[k], torch.bfloat16) if k in ("x", "b", "c") else _t(d[k]) for k in keys}
    _, sref = ref.ssd_ref(*(bf[k] for k in keys), h0=_t(d["h0"]))
    scale = float(sref.abs().max())
    for halves, within in ((1, False), (2, True)):
        _, st = _wgmma_walk(*(bf[k] for k in keys), h0=_t(d["h0"]), halves=halves)
        assert (float((st - sref).abs().max()) <= 3e-5 * scale) == within, halves


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [8, 16, 64, 80, 128, 192])
@pytest.mark.parametrize("n", [16, 32, 64, 96, 128])
def test_ssd_route_rule(dtype, p, n):
    """bf16 with P a multiple of 64 and N 64 or 128 takes the tensor cores;
    fp32 (which would be TF32 there) and other widths stay on the CUDA
    cores."""
    want = ("wgmma" if dtype == torch.bfloat16 and p % 64 == 0 and n in (64, 128)
            else "cuda_cores")
    assert tssd.route(dtype, p, n) == want


def test_ssd_route_rule_matches_kernel():
    """The wrapper's route rule is the .cu's `ssd_scan_route`, the C
    expression evaluated in Python over every dtype and a grid of P and N,
    so the launches the wrapper counts under a route are the ones the
    library takes."""
    src = (Path(tssd.__file__).parent / "csrc" / "ssd_scan.cu").read_text()
    body = re.search(r'extern "C" int ssd_scan_route\(int dtype, int P, int N\) \{\s*'
                     r"return (.*?);\s*\}", src, re.S).group(1)
    expr = compile(" ".join(body.replace("&&", " and ").replace("||", " or ").split()),
                   "ssd_scan_route", "eval")
    codes = {torch.float32: 0, torch.bfloat16: 1}
    for dtype, code in codes.items():
        for p in range(1, 257):
            for n in range(1, tssd.MAX_STATE + 1):
                took = bool(eval(expr, {}, dict(dtype=code, P=p, N=n)))
                assert (tssd.route(dtype, p, n) == "wgmma") == took, (dtype, p, n)


def test_reset_clears_ssd_route_counts():
    tssd.ssd_scan.launches_by_route["wgmma"] += 2
    tssd.ssd_scan.launches += 2
    ops.reset_launch_counts()
    assert tssd.ssd_scan.launches_by_route == {"wgmma": 0, "cuda_cores": 0}
    assert ops.launch_counts()["ssd_scan"] == 0


@pytest.mark.parametrize("s", [1, 2, 11])
def test_causal_conv_and_step_match_jax(s):
    """The prefill conv over s steps, then one decode step from the last
    W-1 pre-conv inputs, against ``repro.nn.conv``."""
    rng = np.random.default_rng(6)
    bsz, ch, w = 2, 12, 4
    x = rng.standard_normal((bsz, s, ch)).astype(np.float32)
    wt = rng.standard_normal((w, ch)).astype(np.float32)
    bias = rng.standard_normal(ch).astype(np.float32)
    p = conv.CausalConv(ch, w)
    p.w.data, p.b.data = torch.from_numpy(wt), torch.from_numpy(bias)
    jp = {"w": jnp.asarray(wt), "b": jnp.asarray(bias)}
    _close(conv.causal_conv(p, torch.from_numpy(x)), jconv.causal_conv(jp, jnp.asarray(x)),
           atol=1e-6, rtol=1e-6)
    state = rng.standard_normal((bsz, w - 1, ch)).astype(np.float32)
    xt = rng.standard_normal((bsz, 1, ch)).astype(np.float32)
    ty, ts = conv.causal_conv_step(p, torch.from_numpy(xt), torch.from_numpy(state))
    jy, js = jconv.causal_conv_step(jp, jnp.asarray(xt), jnp.asarray(state))
    _close(ty, jy, atol=1e-6, rtol=1e-6)
    _close(ts, js, atol=0, rtol=0)
    assert tuple(conv.conv_state_init(bsz, ch, w, torch.bfloat16, "cpu").shape) == (bsz, w - 1, ch)


def test_ssm_initialisers_draw_the_jax_ranges():
    """A = -exp(A_log) in [-16, -1]; softplus(dt_bias) log-uniform in
    [1e-3, 1e-1], as ``repro.nn.init.dt_bias_init``."""
    gen = torch.Generator().manual_seed(0)
    a_log = init.a_log_init(gen, (4000,), torch.float32, "cpu")
    assert float(a_log.min()) >= 0.0 and float(a_log.max()) <= np.log(16.0) + 1e-6
    dtb = init.dt_bias_init()(gen, (4000,), torch.float32, "cpu")
    dt = torch.nn.functional.softplus(dtb)
    assert float(dt.min()) >= 1e-3 * (1 - 1e-4) and float(dt.max()) <= 1e-1 * (1 + 1e-4)
    assert abs(float(torch.log(dt).mean()) - np.log(1e-2)) < 0.1   # log-uniform centre
    jdt = jax.nn.softplus(jssd.inits.dt_bias_init()(jax.random.PRNGKey(0), (4000,)))
    assert abs(float(jnp.log(jdt).mean()) - float(torch.log(dt).mean())) < 0.15
