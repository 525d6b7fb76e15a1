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
kernel to. K3-bwd's plain version (``ops.ssd_scan_bwd_plain``, the passes
the kernel runs) is held to ``jax.vjp`` of ``repro.nn.ssd.ssd_chunked`` and
to autograd of the plain forward: every gradient within 1e-4 of its own
max. An emulation of K3's fp32 route and of K3-bwd (their chunk-parallel
passes, fixed-order reduces and 3xTF32 products) is held to the same
references at the same bounds, and one TF32 product shown to miss them.
An emulation of K3-bwd's bf16 ``wgmma`` route (bf16 products, every fp32
operand as hi + lo bf16 parts, the heads' dB and dC summed in the kernel's
order) is held to jitted ``jax.vjp`` of ``ssd_chunked`` in fp32 at 1e-4 of
each gradient's max and, once dx, db and dc are rounded to bf16, to the
plain backward at 1e-2; with one bf16 part it misses the first bound. The
route rules (K3's and K3-bwd's) are held to the ``.cu``'s.
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


@pytest.mark.parametrize("s,g,with_h0,with_dstate,chunk", [
    (128, 1, False, False, 64),    # two whole chunks, one group, no state
    (100, 1, True, True, 64),      # ragged S, h0 and d(final state)
    (77, 2, True, False, 16),      # G < H, ragged against both chunk lengths
    (40, 4, False, True, 8),       # G == H, the d(final state) alone
    (9, 2, True, True, 64),        # S under one chunk
])
def test_ssd_scan_bwd_plain_matches_jax_vjp(s, g, with_h0, with_dstate, chunk):
    """K3-bwd's plain version against jax.vjp of the function the JAX model
    differentiates, ``repro.nn.ssd.ssd_chunked`` (its chunk of 16, the smoke
    config's), and autograd of ``ops.ssd_scan_plain``, both on dy and a
    d(final state) drawn from numpy: dx, ddt, da, db, dc and dh0 each within
    1e-4 of its own max. dh0 is None without h0."""
    b, h, p, n = 2, 4, 8, 16
    d = _inputs(6, b, s, h, p, n, g, h0=with_h0)
    rng = np.random.default_rng(7)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dstate = rng.standard_normal((b, h, p, n)).astype(np.float32) if with_dstate else None
    keys = ("x", "dt", "a", "b", "c") + (("h0",) if with_h0 else ())
    got = ops.ssd_scan_bwd_plain(*(_t(d[k]) for k in ("x", "dt", "a", "b", "c", "h0")),
                                 _t(dy), _t(dstate), chunk=chunk)
    assert len(got) == 6 and (got[5] is None) == (not with_h0)

    def fn(*args):
        return jssd.ssd_chunked(*args[:5], 16, h0=args[5] if with_h0 else None)
    (_, final), vjp = jax.vjp(fn, *(_j(d[k]) for k in keys))
    want = vjp((_j(dy), jnp.zeros_like(final) if dstate is None else _j(dstate)))
    leaves = [_t(d[k]).requires_grad_() for k in keys]
    y, state = ops.ssd_scan_plain(*leaves[:5], chunk=16, h0=leaves[5] if with_h0 else None)
    loss = (y * _t(dy)).sum() + (0 if dstate is None else (state * _t(dstate)).sum())
    auto = torch.autograd.grad(loss, leaves)
    for name, g_, j, a_ in zip(("dx", "ddt", "da", "db", "dc", "dh0"), got, want, auto):
        assert g_.shape == a_.shape, name
        for ref_ in (np.asarray(j), a_.numpy()):
            scale = float(np.abs(ref_).max())
            np.testing.assert_allclose(g_.numpy(), ref_, atol=1e-4 * scale, rtol=0, err_msg=name)


def test_ssd_scan_bwd_wrapper_refuses_cpu_and_autograd_takes_plain():
    """K3-bwd's wrapper never falls back (CPU tensors are an error there);
    on the CPU ``ops.ssd_scan`` under autograd differentiates the plain
    version, its gradients those of ``ssd_scan_bwd_plain``."""
    d = _inputs(8, 1, 20, 2, 4, 8, 1, h0=True)
    args = [_t(d[k]) for k in ("x", "dt", "a", "b", "c")]
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_scan_bwd(*args, None, torch.zeros(1, 20, 2, 4), None)
    with pytest.raises(TypeError, match="fp32"):
        tssd.ssd_scan_bwd(*args, None, torch.zeros(1, 20, 2, 4).double(), None)
    leaves = [t.clone().requires_grad_() for t in args + [_t(d["h0"])]]
    y = ops.ssd_scan(*leaves[:5], chunk=8, h0=leaves[5])
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(0))
    auto = torch.autograd.grad((y * dy).sum(), leaves)
    plain = ops.ssd_scan_bwd_plain(*args, _t(d["h0"]), dy, None)
    for g_, p_ in zip(auto, plain):
        torch.testing.assert_close(g_, p_, atol=1e-4 * float(p_.abs().max()), rtol=0)
    assert ops.launch_counts()["ssd_scan_bwd"] == 0


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


def _tf32(x, rna):
    """x's TF32 value: rounded to nearest, ties away from zero (`rna`, the
    kernels' big part, as cvt.rna.tf32.f32), or truncated (the tensor
    core's reading of the small part)."""
    bits = x.contiguous().view(torch.int32)
    if rna:
        bits = bits + 0x1000
    return (bits & -0x2000).view(torch.float32)


def _mm3(eq, a, b, terms=3):
    """The einsum `eq` as the kernels' `mma.sync` products: each fp32
    operand split into big (rounded) and small (x - big, truncated), and
    small.big + big.small + big.big in fp32 (terms 3), or big.big alone
    (terms 1, one TF32 product)."""
    ab, bb = _tf32(a, True), _tf32(b, True)
    if terms == 1:
        return torch.einsum(eq, ab, bb)
    return (torch.einsum(eq, _tf32(a - ab, False), bb) + torch.einsum(eq, ab, _tf32(b - bb, False))
            + torch.einsum(eq, ab, bb))


def _tf32x3_chunks(x, dt, a, b, c, L=64):
    """The chunk layout of the 3xTF32 route: steps padded with zeros to
    whole chunks of L (dt 0 past S), b and c per head, cs the inclusive
    cumsum of dt a within a chunk, w_s = exp(cs_L - cs_s) dt_s."""
    bsz, s, h, p = x.shape
    g = b.shape[2]
    pad = -s % L
    x, b, c = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, b, c))
    dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    nc = x.shape[1] // L
    xc = x.reshape(bsz, nc, L, h, p)
    bc, cc = (t.reshape(bsz, nc, L, g, -1).repeat_interleave(h // g, dim=3) for t in (b, c))
    dtc = dt.reshape(bsz, nc, L, h)
    cs = torch.cumsum(dtc * a, dim=2)
    w = torch.exp(cs[:, :, -1:] - cs) * dtc
    return xc, bc, cc, dtc, cs, w


def _pass(summ, cs_l, init, reverse=False):
    """(b) the passing across chunks, one chunk at a time: each chunk's
    entry replaced by the running value before it, which becomes
    exp(cs_L) run + summary. summ (B, nc, H, P, N); returns (entries, what
    is left)."""
    run, out = init, [None] * summ.shape[1]
    for ci in (range(summ.shape[1] - 1, -1, -1) if reverse else range(summ.shape[1])):
        out[ci] = run
        run = torch.exp(cs_l[:, ci])[..., None, None] * run + summ[:, ci]
    return torch.stack(out, dim=1), run


def _tf32x3_walk(x, dt, a, b, c, h0=None, terms=3):
    """K3's 3xTF32 route (``ssd_scan.cu``'s `ssd_state_kernel`,
    `ssd_pass_kernel`, `ssd_out_kernel`): (a) each chunk's state s_c =
    (w x)^T B; (b) the passing, S_{c-1} from h0; (c) y = exp(cs_t) C
    S_{c-1}^T + M X, M from C B^T with the decay and dt, masked to s <= t
    before exp; every product `_mm3`. fp32 (B,S,H,P) etc.; returns (y,
    final state)."""
    bsz, s, h, p = x.shape
    n = b.shape[3]
    xc, bc, cc, dtc, cs, w = _tf32x3_chunks(x, dt, a, b, c)
    L = xc.shape[2]
    s_chunk = _mm3("bclhp,bclhn->bchpn", xc * w[..., None], bc, terms)
    init = torch.zeros(bsz, h, p, n) if h0 is None else h0
    prev, final = _pass(s_chunk, cs[:, :, -1], init)
    causal = torch.ones(L, L, dtype=torch.bool).tril()
    gm = _mm3("bclhn,bcmhn->bchlm", cc, bc, terms)
    decay = (cs[..., :, None, :] - cs[..., None, :, :]).movedim(-1, 2)
    m = torch.where(causal, gm * torch.exp(torch.where(causal, decay, -torch.inf))
                    * dtc.movedim(-1, 2)[..., None, :], 0.0)
    y = torch.exp(cs)[..., None] * _mm3("bclhn,bchpn->bclhp", cc, prev, terms) \
        + _mm3("bchlm,bcmhp->bclhp", m, xc, terms)
    return y.reshape(bsz, -1, h, p)[:, :s], final


def _tf32x3_bwd_walk(x, dt, a, b, c, h0, dy, dstate, terms=3, PT=64):
    """K3-bwd (``ssd_scan_bwd.cu``): (a) s_c and ds_c = (exp(cs) dy)^T C;
    (b) S_{c-1} forward from h0, dS_c backward from dstate (dh0 what is
    left); (c) per chunk and 64-column p tile, every product `_mm3`: C B^T,
    B dS^T, dy x^T, M^T dy, dy S, dG B, x dS, dG^T C, then d(cs), its
    reverse cumsum, ddt and da, as each unit computes them; the reduces sum
    the tiles' partials in order (dB and dC also over a group's heads,
    head order; da over tiles, batch, chunks). Returns (dx, ddt, da, db,
    dc, dh0)."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    xc, bc, cc, dtc, cs, w = _tf32x3_chunks(x, dt, a, b, c)
    dyc = _tf32x3_chunks(dy, dt, a, b, c)[0]
    L, nc = xc.shape[2], xc.shape[1]
    ecs = torch.exp(cs)
    cs_l = cs[:, :, -1]
    zero = torch.zeros(bsz, h, p, n)
    prev, _ = _pass(_mm3("bclhp,bclhn->bchpn", xc * w[..., None], bc, terms), cs_l,
                    zero if h0 is None else h0)
    after, dh0 = _pass(_mm3("bclhp,bclhn->bchpn", dyc * ecs[..., None], cc, terms), cs_l,
                       zero if dstate is None else dstate, reverse=True)
    causal = torch.ones(L, L, dtype=torch.bool).tril()
    e = torch.exp(torch.where(causal, (cs[..., :, None, :] - cs[..., None, :, :]).movedim(-1, 2),
                              -torch.inf))                     # (B,nc,H,t,s)
    dt_s = dtc.movedim(-1, 2)[..., None, :]
    gm = _mm3("bclhn,bcmhn->bchlm", cc, bc, terms)
    m = gm * e * dt_s
    dx = torch.zeros_like(xc)
    parts = []                                                  # (ddt, da, db, dc) a tile
    for p0 in range(0, p, PT):
        ps = slice(p0, p0 + PT)
        xt, dyt, st, dst = xc[..., ps], dyc[..., ps], prev[..., ps, :], after[..., ps, :]
        u = _mm3("bcshn,bchpn->bcshp", bc, dst, terms)          # B dS^T
        dm = _mm3("bclhp,bcmhp->bchlm", dyt, xt, terms)         # dy x^T
        dg, r = dm * e * dt_s, dm * gm * e
        dx[..., ps] = _mm3("bchts,bcthp->bcshp", m, dyt, terms) + w[..., None] * u
        dw = (xt * u).sum(-1)
        z = _mm3("bcthp,bchpn->bcthn", dyt, st, terms)          # dy S_{c-1}
        dcm = ecs[..., None] * z + _mm3("bchts,bcshn->bcthn", dg, bc, terms)
        dbm = w[..., None] * _mm3("bcshp,bchpn->bcshn", xt, dst, terms) \
            + _mm3("bchts,bcthn->bcshn", dg, cc, terms)
        col = r.sum(-2).movedim(-1, 2)
        dcs = (r * dt_s).sum(-1).movedim(-1, 2) - dtc * col + ecs * (cc * z).sum(-1) - dw * w
        dcs[:, :, -1] += (dw * w).sum(2) + torch.exp(cs_l) * (dst * st).sum((-2, -1))
        rc = dcs.flip(2).cumsum(2).flip(2)
        ddt = col + dw * torch.exp(cs_l[:, :, None] - cs) + a * rc
        parts.append((ddt, (dtc * rc).sum(2), dbm, dcm))         # da: (B,nc,H) a tile

    def steps(t):
        return t.reshape(bsz, nc * L, *t.shape[3:])[:, :s]

    def fixed_sum(ts):
        out = ts[0]
        for t in ts[1:]:
            out = out + t
        return out
    ddt = fixed_sum([steps(q[0]) for q in parts])
    da = fixed_sum([q[1][bi, ci] for q in parts for bi in range(bsz) for ci in range(nc)])
    group = lambda t: fixed_sum(list(t.reshape(bsz, s, g, h // g, n).unbind(3)))   # noqa: E731
    db = fixed_sum([group(steps(q[2])) for q in parts])
    dc = fixed_sum([group(steps(q[3])) for q in parts])
    return steps(dx), ddt, da, db, dc, (None if h0 is None else dh0)


@pytest.mark.parametrize("s,g,n,p,with_h0", [
    (128, 4, 128, 64, False),   # two chunks: the Pallas kernel in interpret mode
    (128, 2, 64, 64, False),    # G < H, N 64: the Pallas kernel
    (200, 1, 128, 64, True),    # ragged S over four chunks, h0
    (37, 2, 128, 80, True),     # under one chunk, P off 64 (two p tiles)
    (100, 2, 64, 80, False),    # ragged S, P 80, N 64
])
def test_ssd_tf32x3_walk_matches_pallas(s, g, n, p, with_h0):
    """K3's 3xTF32 route as its passes (64-step chunks, each chunk's state,
    the passing, then y; every product 3xTF32) against the JAX package: y
    against the Pallas kernel in interpret mode (head-expanded b and c, no
    initial state) where S is a multiple of its chunk, else against
    ``ssd_chunked``; y and the final state against the sequential oracle
    ``ssd_ref``; the fp32 tolerances of the K3 tests (3e-5 of the max, rtol
    1e-4)."""
    b, h = 2, 4
    d = _inputs(9, b, s, h, p, n, g, h0=with_h0)
    keys = ("x", "dt", "a", "b", "c")
    y, st = _tf32x3_walk(*(_t(d[k]) for k in keys), h0=_t(d["h0"]))
    assert y.shape == (b, s, h, p) and st.shape == (b, h, p, n)
    rep = lambda t: jnp.repeat(_j(t), h // g, axis=2)   # noqa: E731
    yref, sref = jref.ssd_ref(_j(d["x"]), _j(d["dt"]), _j(d["a"]), rep(d["b"]), rep(d["c"]),
                              h0=_j(d["h0"]))
    if s % 64 == 0 and not with_h0:
        want = jops.ssd_scan(_j(d["x"]), _j(d["dt"]), _j(d["a"]), rep(d["b"]), rep(d["c"]),
                             chunk=64)
    else:
        want, _ = jax.jit(jssd.ssd_chunked, static_argnums=5)(*(_j(d[k]) for k in keys), 64,
                                                               h0=_j(d["h0"]))
    _close(y, want, scale_of=yref)
    _close(y, yref)
    _close(st, sref)


@pytest.mark.parametrize("s,g,n,p,with_h0,with_dstate", [
    (128, 1, 128, 64, False, False),   # two whole chunks, one group
    (100, 2, 64, 64, True, True),      # ragged S, G < H, h0 and d(final state)
    (37, 2, 128, 80, True, False),     # under one chunk, P off 64
    (150, 4, 64, 80, False, True),     # G == H, ragged, two p tiles
])
def test_ssd_tf32x3_bwd_walk_matches_jax_vjp(s, g, n, p, with_h0, with_dstate):
    """K3-bwd's passes with their 3xTF32 products and fixed-order reduces
    against jax.vjp of ``repro.nn.ssd.ssd_chunked`` and the plain backward
    ``ops.ssd_scan_bwd_plain``: dx, ddt, da, db, dc and dh0 each within
    1e-4 of its own max, the K3-bwd tests' bound."""
    b, h = 2, 4
    d = _inputs(10, b, s, h, p, n, g, h0=with_h0)
    rng = np.random.default_rng(11)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dstate = rng.standard_normal((b, h, p, n)).astype(np.float32) if with_dstate else None
    keys = ("x", "dt", "a", "b", "c") + (("h0",) if with_h0 else ())
    got = _tf32x3_bwd_walk(*(_t(d[k]) for k in ("x", "dt", "a", "b", "c", "h0")), _t(dy),
                           _t(dstate))

    @jax.jit
    def vjp_of_chunked(args, ct):
        _, vjp = jax.vjp(lambda *a: jssd.ssd_chunked(*a[:5], 64, h0=a[5] if with_h0 else None),
                         *args)
        return vjp(ct)
    want = vjp_of_chunked(tuple(_j(d[k]) for k in keys),
                          (_j(dy), jnp.zeros((b, h, p, n)) if dstate is None else _j(dstate)))
    plain = ops.ssd_scan_bwd_plain(*(_t(d[k]) for k in ("x", "dt", "a", "b", "c", "h0")),
                                   _t(dy), _t(dstate))
    assert (got[5] is None) == (not with_h0)
    for name, g_, j, p_ in zip(("dx", "ddt", "da", "db", "dc", "dh0"), got, want, plain):
        for ref_ in (np.asarray(j), p_.numpy()):
            assert g_.shape == ref_.shape, name
            scale = float(np.abs(ref_).max())
            np.testing.assert_allclose(g_.numpy(), ref_, atol=1e-4 * scale, rtol=0, err_msg=name)


def test_ssd_tf32x3_needs_three_products():
    """The fp32 bounds are what the three products buy: with one TF32
    product (big.big) the forward's y misses 3e-5 of its max against
    ``ssd_ref`` and the backward misses 1e-4 of a gradient's max against
    the plain backward; with three both hold."""
    b, s, h, p, n, g = 2, 128, 4, 64, 128, 1
    d = _inputs(12, b, s, h, p, n, g, h0=True)
    args = [_t(d[k]) for k in ("x", "dt", "a", "b", "c")]
    yref, _ = ref.ssd_ref(*args[:3], *(t.repeat_interleave(h // g, 2) for t in args[3:]),
                          h0=_t(d["h0"]))
    dy = _t(np.random.default_rng(13).standard_normal((b, s, h, p)).astype(np.float32))
    plain = ops.ssd_scan_bwd_plain(*args, _t(d["h0"]), dy, None)
    for terms, within in ((1, False), (3, True)):
        y, _ = _tf32x3_walk(*args, h0=_t(d["h0"]), terms=terms)
        fwd_ok = float((y - yref).abs().max()) <= 3e-5 * float(yref.abs().max())
        got = _tf32x3_bwd_walk(*args, _t(d["h0"]), dy, None, terms=terms)
        bwd_ok = all(float((x_ - w_).abs().max()) <= 1e-4 * float(w_.abs().max())
                     for x_, w_ in zip(got, plain))
        assert fwd_ok == within and bwd_ok == within, terms


def _bf16_parts(v, halves):
    """v (fp32) as `halves` bf16 parts, largest first, each the bf16
    rounding of what the parts before it leave (``split_bf16`` of the
    .cu), as fp32 tensors."""
    parts = []
    for _ in range(halves):
        part = v.to(torch.bfloat16).float()
        parts.append(part)
        v = v - part
    return parts


def _mm_parts(eq, a, b, halves):
    """The einsum `eq` as the `wgmma` route's products: the fp32 operand `a`
    in `halves` bf16 parts, one product a part (b bf16-valued, so each is
    exact) summed in fp32."""
    out = None
    for part in _bf16_parts(a, halves):
        t = torch.einsum(eq, part, b)
        out = t if out is None else out + t
    return out


def _bf16_wgmma_bwd_walk(x, dt, a, b, c, h0, dy, dstate, halves=2, heads_per_cta=None):
    """K3-bwd's `wgmma` route (``ssd_scan_bwd.cu``, namespace `wg`) as its
    arithmetic, on bf16 x, b, c, dy: (1) the state walks, S_{c-1} forward
    from h0 and dS_c backward from dstate (dh0 what is left), each update a
    product of v = w x or exp(cs) dy, fp32, in `halves` bf16 parts, with B
    or C; S_{c-1} and dS_c kept as `halves` bf16 planes; (2) per chunk and
    head, on 64-step chunks: C·Bᵀ and dy·xᵀ of the bf16 inputs (over every
    p tile) in fp32; M, dG and R from them, the decay masked to s <= t
    before exp; then per 64-column p tile: U = B·dSᵀ, dx = Mᵀ·dy + w U, dw,
    V = x·dS, Z = dy·S, C·Z and <dS, S> over the planes; dB = dGᵀ·C + w V
    and dC = dG·B + exp(cs) Z, every fp32 operand (M, dG) in `halves` parts;
    d(cs), its reverse cumsum, ddt and the chunk's share of da. dB and dC
    sum over a group's heads as a CTA does: `heads_per_cta` heads in order,
    then those sums in order; da over batch and chunks in order. Returns
    (dx, ddt, da, db, dc, dh0) in fp32, before any rounding to bf16."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    per = heads_per_cta or rep
    xc, bc, cc, dtc, cs, w = _tf32x3_chunks(x.float(), dt, a, b.float(), c.float())
    dyc = _tf32x3_chunks(dy.float(), dt, a, b.float(), c.float())[0]
    L, nc = xc.shape[2], xc.shape[1]
    ecs, cs_l = torch.exp(cs), cs[:, :, -1]
    zero = torch.zeros(bsz, h, p, n)
    prev, _ = _pass(_mm_parts("bclhp,bclhn->bchpn", xc * w[..., None], bc, halves), cs_l,
                    zero if h0 is None else h0)
    after, dh0 = _pass(_mm_parts("bclhp,bclhn->bchpn", dyc * ecs[..., None], cc, halves), cs_l,
                       zero if dstate is None else dstate, reverse=True)
    prev_parts, after_parts = _bf16_parts(prev, halves), _bf16_parts(after, halves)
    causal = torch.ones(L, L, dtype=torch.bool).tril()
    e = torch.exp(torch.where(causal, (cs[..., :, None, :] - cs[..., None, :, :]).movedim(-1, 2),
                              -torch.inf))                     # (B,nc,H,t,s)
    dt_s = dtc.movedim(-1, 2)[..., None, :]
    gm = torch.einsum("bclhn,bcmhn->bchlm", cc, bc)             # C B^T, exact products
    dm = torch.einsum("bclhp,bcmhp->bchlm", dyc, xc)            # dy x^T over every p tile
    m, dg, r = gm * e * dt_s, dm * e * dt_s, dm * gm * e
    dx = torch.zeros_like(xc)
    dw = torch.zeros_like(dtc)
    cz = torch.zeros_like(dtc)
    ip = torch.zeros_like(cs_l)
    dbm = _mm_parts("bchts,bcthn->bcshn", dg, cc, halves)        # dG^T C
    dcm = _mm_parts("bchts,bcshn->bcthn", dg, bc, halves)        # dG B
    for p0 in range(0, p, 64):
        ps = slice(p0, p0 + 64)
        xt, dyt = xc[..., ps], dyc[..., ps]
        sp = [t[..., ps, :] for t in prev_parts]
        dsp = [t[..., ps, :] for t in after_parts]
        u = sum(torch.einsum("bcshn,bchpn->bcshp", bc, t) for t in dsp)      # B dS^T
        dx[..., ps] = _mm_parts("bchts,bcthp->bcshp", m, dyt, halves) + w[..., None] * u
        dw = dw + (xt * u).sum(-1)
        v = sum(torch.einsum("bcshp,bchpn->bcshn", xt, t) for t in dsp)      # x dS
        z = sum(torch.einsum("bcthp,bchpn->bcthn", dyt, t) for t in sp)      # dy S_{c-1}
        dbm = dbm + w[..., None] * v
        dcm = dcm + ecs[..., None] * z
        cz = cz + (cc * z).sum(-1)
        ip = ip + (sum(dsp) * sum(sp)).sum((-2, -1))
    col = r.sum(-2).movedim(-1, 2)
    dcs = (r * dt_s).sum(-1).movedim(-1, 2) - dtc * col + ecs * cz - dw * w
    dcs[:, :, -1] += (dw * w).sum(2) + torch.exp(cs_l) * ip
    rc = dcs.flip(2).cumsum(2).flip(2)
    ddt = col + dw * torch.exp(cs_l[:, :, None] - cs) + a * rc

    def steps(t):
        return t.reshape(bsz, nc * L, *t.shape[3:])[:, :s]

    def fixed_sum(ts):
        out = ts[0]
        for t in ts[1:]:
            out = out + t
        return out

    def group(t):   # (B, S, H, N) -> (B, S, G, N): heads in CTAs of `per`, in order
        t = steps(t).reshape(bsz, s, g, rep, n)
        return fixed_sum([fixed_sum(list(t[:, :, :, k:k + per].unbind(3)))
                          for k in range(0, rep, per)])
    da_parts = (dtc * rc).sum(2)                                  # (B, nc, H)
    da = fixed_sum([da_parts[bi, ci] for bi in range(bsz) for ci in range(nc)])
    return (steps(dx), steps(ddt), da, group(dbm), group(dcm),
            None if h0 is None else dh0)


def _bf16_inputs(seed, b, s, h, p, n, g, with_h0, with_dstate):
    """numpy inputs of the bf16 backward, x, b, c and dy rounded to bf16
    values (kept as fp32 arrays), dt, a, h0 and d(final state) fp32."""
    d = _inputs(seed, b, s, h, p, n, g, h0=with_h0)
    rng = np.random.default_rng(seed + 1)
    d["dy"] = rng.standard_normal((b, s, h, p)).astype(np.float32)
    d["dstate"] = (rng.standard_normal((b, h, p, n)).astype(np.float32)
                   if with_dstate else None)
    for k in ("x", "b", "c", "dy"):
        d[k] = torch.from_numpy(d[k]).bfloat16().float().numpy()
    return d


BF16_BWD_KEYS = ("x", "dt", "a", "b", "c", "h0", "dy", "dstate")


@pytest.mark.parametrize("s,g,n,p,with_h0,with_dstate,per", [
    (128, 1, 128, 64, False, False, None),   # two whole chunks, one group
    (100, 2, 64, 64, True, True, None),      # ragged S, G < H, h0 and d(final state)
    (37, 2, 128, 128, True, False, None),    # under one chunk, P 128 (two p tiles)
    (150, 1, 64, 128, False, True, 3),       # ragged, P 128, N 64, heads in CTAs of 3
    (200, 4, 128, 64, True, True, None),     # G == H, ragged over four chunks
])
def test_bf16_wgmma_bwd_walk_matches_jax_vjp(s, g, n, p, with_h0, with_dstate, per):
    """K3-bwd's `wgmma` route as its arithmetic (``_bf16_wgmma_bwd_walk``)
    against jitted jax.vjp of ``repro.nn.ssd.ssd_chunked`` in fp32 on the
    same bf16-valued inputs: every gradient within 1e-4 of its own max
    before dx, db and dc are rounded; after that rounding, against the
    plain backward ``ops.ssd_scan_bwd_plain`` on bf16 inputs within
    BF16_GRAD_TOL (1e-2) of the max, the card's check of the kernel."""
    b, h = 2, 4
    d = _bf16_inputs(20, b, s, h, p, n, g, with_h0, with_dstate)
    args = [_t(d[k]) for k in BF16_BWD_KEYS]
    got = _bf16_wgmma_bwd_walk(*args, heads_per_cta=per)
    keys = ("x", "dt", "a", "b", "c") + (("h0",) if with_h0 else ())

    @jax.jit
    def vjp_of_chunked(ins, ct):
        _, vjp = jax.vjp(lambda *a: jssd.ssd_chunked(*a[:5], 64, h0=a[5] if with_h0 else None),
                         *ins)
        return vjp(ct)
    want = vjp_of_chunked(tuple(_j(d[k]) for k in keys),
                          (_j(d["dy"]), jnp.zeros((b, h, p, n)) if d["dstate"] is None
                           else _j(d["dstate"])))
    bf = {"x", "b", "c", "dy"}
    plain = ops.ssd_scan_bwd_plain(*(_t(d[k], torch.bfloat16 if k in bf else torch.float32)
                                     for k in BF16_BWD_KEYS))
    assert (got[5] is None) == (not with_h0)
    for name, g_, j, p_ in zip(("dx", "ddt", "da", "db", "dc", "dh0"), got, want, plain):
        j = np.asarray(j)
        assert g_.shape == j.shape == p_.shape, name
        np.testing.assert_allclose(g_.numpy(), j, atol=1e-4 * float(np.abs(j).max()), rtol=0,
                                   err_msg=name)
        if name in ("dx", "db", "dc"):
            assert p_.dtype == torch.bfloat16
            g_ = g_.bfloat16()
        scale = float(p_.float().abs().max())
        np.testing.assert_allclose(g_.float().numpy(), p_.float().numpy(), atol=1e-2 * scale,
                                   rtol=0, err_msg=name)


def test_ssd_bf16_bwd_needs_the_low_half():
    """The 1e-4 bounds are what the hi + lo parts buy: with every fp32
    operand (v of the state walks, the planes of S_{c-1} and dS_c, M and
    dG) in one bf16 part, some gradient of the walk misses 1e-4 of its max
    against the fp32 plain backward on the same bf16 values; with two every
    gradient holds."""
    b, s, h, p, n, g = 2, 128, 4, 64, 128, 1
    d = _bf16_inputs(21, b, s, h, p, n, g, True, True)
    args = [_t(d[k]) for k in BF16_BWD_KEYS]
    plain = ops.ssd_scan_bwd_plain(*args)
    for halves, within in ((1, False), (2, True)):
        got = _bf16_wgmma_bwd_walk(*args, halves=halves)
        ok = all(float((x_ - w_).abs().max()) <= 1e-4 * float(w_.abs().max())
                 for x_, w_ in zip(got, plain))
        assert ok == within, halves


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [8, 16, 64, 80, 128, 192])
@pytest.mark.parametrize("n", [16, 32, 64, 96, 128])
def test_ssd_route_rule(dtype, p, n):
    """bf16 with P a multiple of 64 and N 64 or 128 takes the tensor cores
    by wgmma; fp32 takes the 3xTF32 route at every P and N; bf16 at other
    widths stays on the CUDA cores. K3-bwd follows the same widths: bf16
    there on its wgmma route, elsewhere on the staged one, fp32 on 3xTF32."""
    if dtype == torch.float32:
        want = bwd_want = "tf32x3"
    else:
        wide = p % 64 == 0 and n in (64, 128)
        want = "wgmma" if wide else "cuda_cores"
        bwd_want = "wgmma" if wide else "staged"
    assert tssd.route(dtype, p, n) == want
    assert tssd.bwd_route(dtype, p, n) == bwd_want


def test_ssd_route_rule_matches_kernel():
    """The wrapper's route rule is the .cu's `ssd_scan_route`, the C
    expression evaluated in Python over every dtype and a grid of P and N
    (it returns an index into ``ROUTES``), so the launches the wrapper
    counts under a route are the ones the library takes."""
    src = (Path(tssd.__file__).parent / "csrc" / "ssd_scan.cu").read_text()
    body = re.search(r'extern "C" int ssd_scan_route\(int dtype, int P, int N\) \{\s*'
                     r"return (.*?);\s*\}", src, re.S).group(1)
    expr = compile(" ".join(body.replace("&&", " and ").replace("||", " or ").split()),
                   "ssd_scan_route", "eval")
    codes = {torch.float32: 0, torch.bfloat16: 1}
    for dtype, code in codes.items():
        for p in range(1, 257):
            for n in range(1, tssd.MAX_STATE + 1):
                took = tssd.ROUTES[eval(expr, {}, dict(dtype=code, P=p, N=n))]
                assert tssd.route(dtype, p, n) == took, (dtype, p, n)


def test_ssd_bwd_route_rule_matches_kernel():
    """K3-bwd's route rule is the .cu's `ssd_scan_bwd_route` (an index into
    ``BWD_ROUTES``), the C expression evaluated in Python over both dtypes
    and a grid of P and N, as ``test_ssd_route_rule_matches_kernel`` holds
    K3's."""
    src = (Path(tssd.__file__).parent / "csrc" / "ssd_scan_bwd.cu").read_text()
    body = re.search(r'extern "C" int ssd_scan_bwd_route\(int dtype, int P, int N\) \{\s*'
                     r"return (.*?);\s*\}", src, re.S).group(1)
    expr = compile(" ".join(body.replace("&&", " and ").replace("||", " or ").split()),
                   "ssd_scan_bwd_route", "eval")
    codes = {torch.float32: 0, torch.bfloat16: 1}
    seen = set()
    for dtype, code in codes.items():
        for p in range(1, 257):
            for n in range(1, tssd.MAX_STATE + 1):
                took = tssd.BWD_ROUTES[int(eval(expr, {}, dict(dtype=code, P=p, N=n)))]
                assert tssd.bwd_route(dtype, p, n) == took, (dtype, p, n)
                seen.add(took)
    assert seen == set(tssd.BWD_ROUTES)


def test_bwd_slices_fill_one_wave():
    """The wgmma backward's slices of a group's heads: at mamba2-2.7b's
    train call on 132 SMs, 8 slices of 10 heads (128 chunk CTAs, one
    wave); never an empty slice; one slice where the grid already fills
    the card; every head in exactly one slice."""
    assert tssd.bwd_slices(4, 256, 80, 1, 132) == 8
    plan = tssd.wgmma_bwd_plan(4, 256, 80, 64, 128, 1, sms=132)
    assert plan["heads_per_cta"] == 10
    assert plan["ssd_bwd_wgmma_chunk_kernel"]["ctas"] == 128
    assert plan["ssd_bwd_wgmma_state_kernel"]["ctas"] == 640
    assert tssd.bwd_slices(64, 4096, 80, 1, 132) == 1
    for b, s, h, g in ((1, 37, 7, 1), (2, 200, 4, 2), (1, 100, 6, 2), (3, 64, 30, 3)):
        slices = tssd.bwd_slices(b, s, h, g, 132)
        rep = h // g
        per = -(-rep // slices)
        assert 1 <= slices <= rep and (slices - 1) * per < rep <= slices * per


def test_reset_clears_ssd_route_counts():
    tssd.ssd_scan.launches_by_route["wgmma"] += 2
    tssd.ssd_scan.launches_by_route["tf32x3"] += 1
    tssd.ssd_scan.launches += 3
    ops.reset_launch_counts()
    assert tssd.ssd_scan.launches_by_route == {"wgmma": 0, "tf32x3": 0, "cuda_cores": 0}
    tssd.ssd_scan_bwd.launches_by_route["wgmma"] += 1
    ops.reset_launch_counts()
    assert tssd.ssd_scan_bwd.launches_by_route == {"tf32x3": 0, "staged": 0, "wgmma": 0}
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


@pytest.mark.parametrize("s,g,with_h0,with_dstate", [
    (128, 1, False, False),   # two whole chunks, one group, no state
    (100, 1, True, True),     # ragged S, h0 and d(final state)
    (77, 2, True, False),     # G < H, ragged
    (9, 2, False, True),      # S under one chunk, the d(final state) alone
])
def test_ssd_scan_bwd_plain_bf16_matches_jax_vjp(s, g, with_h0, with_dstate):
    """K3-bwd's bf16 route, held on the CPU through its plain version:
    ``ops.ssd_scan_bwd_plain`` on bf16 x, b, c and dy (dt, a, h0 and
    d(final state) fp32), which returns dx, db and dc in bf16 and the rest
    in fp32, against jax.vjp of ``repro.nn.ssd.ssd_chunked`` on the same
    bf16 values (its chunk of 16): each gradient within 3e-2 of its max,
    bf16's resolution, since JAX contracts C·Bᵀ and C·S_prev in bf16."""
    b, h, p, n = 2, 4, 8, 16
    d = _inputs(9, b, s, h, p, n, g, h0=with_h0)
    rng = np.random.default_rng(10)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dstate = rng.standard_normal((b, h, p, n)).astype(np.float32) if with_dstate else None
    bf = {"x", "b", "c"}
    targs = {k: _t(d[k], torch.bfloat16 if k in bf else torch.float32)
             for k in ("x", "dt", "a", "b", "c", "h0")}
    tdy = _t(dy, torch.bfloat16)
    got = ops.ssd_scan_bwd_plain(*targs.values(), tdy, _t(dstate))
    names = ("dx", "ddt", "da", "db", "dc", "dh0")
    for name, g_ in zip(names, got):
        if name == "dh0" and not with_h0:
            assert g_ is None
            continue
        assert g_.dtype == (torch.bfloat16 if name in ("dx", "db", "dc") else torch.float32)
    keys = ("x", "dt", "a", "b", "c") + (("h0",) if with_h0 else ())

    def fn(*args):
        return jssd.ssd_chunked(*args[:5], 16, h0=args[5] if with_h0 else None)
    jins = [jnp.asarray(targs[k].float().numpy()).astype(jnp.bfloat16 if k in bf else jnp.float32)
            for k in keys]
    (y, final), vjp = jax.vjp(fn, *jins)
    jdy = jnp.asarray(tdy.float().numpy()).astype(jnp.bfloat16)
    want = vjp((jdy, jnp.zeros_like(final) if dstate is None else _j(dstate)))
    assert y.dtype == jnp.bfloat16
    for name, g_, j in zip(names, got, want):
        j = np.asarray(j, np.float32)
        scale = float(np.abs(j).max())
        np.testing.assert_allclose(g_.float().numpy(), j, atol=3e-2 * scale, rtol=0,
                                   err_msg=name)
