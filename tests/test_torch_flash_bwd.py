"""K1-bwd's tensor-core design (``csrc/flash_attention_bwd.cu``), emulated on
the CPU, against ``jax.vjp`` of the JAX package's attention oracle and the
port's plain backward.

The emulation walks the kernel's tiles (BQ query rows by BKV keys, read
from the ``.cu``): the dK/dV walk visits, for each key tile, only the
query tiles that the mask lets see it, and the dQ walk only the key tiles
the forward walks; only tiles that cross the diagonal, the window's edge,
S or S_kv are masked (k and v may have S_kv rows of their own, unmasked,
the encoder-decoder's cross-attention); each D-wide product (dV, dK, dQ) sums its k-splits (its
warps' shares of a tile's 32 rows or keys, as the ``.cu``'s ``Tc<D>``
splits them) apart and adds them in order at the end; dK and dV sum each
kv head's query heads' shares. Each product is taken as the kernel takes
it on ``mma.sync``: each fp32 operand split into a big part, rounded to
TF32 as ``cvt.rna.tf32.f32`` rounds (emulated on the fp32 bits), and a
small part x - big, which the tensor core truncates to TF32; then
a_small b_big + a_big b_small + a_big b_big ("3xTF32"). Held at 1e-4 of
each gradient's max, as ``chip_smoke.py`` holds the kernel
(``GRAD_TOL``); one case also walks with single TF32 products, whose
error is at least 10x larger. The plain backward at S_kv != S is also held
to ``jax.vjp`` of the model's attention, ``repro.nn.attention.attend_ref``.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.nn import attention as jattention  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

GRAD_TOL = 1e-4
CU = Path(ops.__file__).resolve().parent / "csrc" / "flash_attention_bwd.cu"


def _constant(name):
    return int(re.search(rf"^constexpr int {name} = (\d+);", CU.read_text(), re.M).group(1))


BQ, BKV, NT = _constant("BQ"), _constant("BKV"), _constant("NT")


def _k_splits(d):
    """The .cu's Tc<D>: n-blocks NB of a D-wide product, and its k-splits,
    dK/dV with half the CTA's warps a product, dQ with all of them."""
    nb = min(4, d // 8)
    warps = NT // 32
    return warps // 2 // (2 * nb), warps // (2 * nb)


def tf32(x):
    """cvt.rna.tf32.f32: x rounded to a 10-bit mantissa, to nearest with
    ties away from zero, on the fp32 bits (the kernel's big part)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x):
    """x truncated to a 10-bit mantissa: what the tensor core reads of an
    fp32 register (the kernel's small part, x - big, goes in as it is)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def mm_3xtf32(a, b):
    ab, bb = tf32(a), tf32(b)
    a_small, b_small = tf32_trunc(a - ab), tf32_trunc(b - bb)
    return a_small @ bb + ab @ b_small + ab @ bb


def mm_tf32(a, b):
    return tf32(a) @ tf32(b)


def _edge(q0, k0, s, skv, causal, window):
    return (q0 + BQ > s or k0 + BKV > skv or (causal and k0 + BKV - 1 > q0)
            or (window > 0 and q0 + BQ - 1 - k0 >= window))


def _p_dx(x_raw, dp, lse, delta, rows, keys, s, skv, edge, scale, causal, window, softcap):
    """P and dX of a score tile (rows x keys), as the kernel's p_and_dx."""
    x, dxdt = x_raw * scale, 1.0
    if softcap:
        th = torch.tanh(x / softcap)
        x, dxdt = softcap * th, 1.0 - th * th
    ok = torch.ones_like(x, dtype=torch.bool)
    if edge:
        r, c = rows[:, None], keys[None, :]
        ok = (r < s) & (c < skv)
        if causal:
            ok &= c <= r
        if window > 0:
            ok &= (r - c) < window
    p = torch.where(ok, torch.exp(x - lse[:, None]), 0.0)
    return p, p * (dp - delta[:, None]) * dxdt


def _tile_walk(q, k, v, o, lse, do, *, scale, causal, window, softcap, mm):
    """(dq, dk, dv) by K1-bwd's tile walk with products `mm`."""
    b, s, h, d = q.shape
    kh, skv = k.shape[2], k.shape[1]
    n = -(-max(s, skv) // BQ) * BQ
    pad = lambda x: torch.cat([x, x.new_zeros(n - x.shape[0], *x.shape[1:])])   # noqa: E731
    delta = (do * o).sum(-1)                                              # (B,S,H)
    dq, dkh, dvh = torch.zeros(b, s, h, d), torch.zeros(b, skv, h, d), torch.zeros(b, skv, h, d)
    ks_dkdv, ks_dq = _k_splits(d)

    def split_product(a, b_, parts, n):
        """parts[j] += a[:, c_j] . b_[c_j] over the n k-splits c_j of a's columns."""
        for j, part in enumerate(parts):
            c = slice(j * a.shape[1] // n, (j + 1) * a.shape[1] // n)
            part += mm(a[:, c].contiguous(), b_[c])
    for bi in range(b):
        for hi in range(h):
            kvh = hi // (h // kh)
            qh, doh, kk, vv = (pad(x[bi, :, j]) for x, j in ((q, hi), (do, hi), (k, kvh),
                                                               (v, kvh)))
            lh, eh = pad(lse[bi, hi]), pad(delta[bi, :, hi])
            for k0 in range(0, skv, BKV):                # dK/dV: a CTA a key tile
                kt, vt, keys = kk[k0:k0 + BKV], vv[k0:k0 + BKV], torch.arange(k0, k0 + BKV)
                acc_k = [torch.zeros(BKV, d) for _ in range(ks_dkdv)]
                acc_v = [torch.zeros(BKV, d) for _ in range(ks_dkdv)]
                q_end = min(s, k0 + BKV - 1 + window) if window > 0 else s
                for q0 in range(k0 if causal else 0, q_end, BQ):
                    sl = slice(q0, q0 + BQ)
                    rows = torch.arange(q0, q0 + BQ)
                    p, dx = _p_dx(mm(qh[sl], kt.T), mm(doh[sl], vt.T), lh[sl], eh[sl], rows,
                                  keys, s, skv, _edge(q0, k0, s, skv, causal, window), scale,
                                  causal, window, softcap)
                    split_product(p.T, doh[sl], acc_v, ks_dkdv)
                    split_product(dx.T, qh[sl], acc_k, ks_dkdv)
                m = min(BKV, skv - k0)
                dvh[bi, k0:k0 + m, hi] = sum(acc_v[1:], acc_v[0])[:m]
                dkh[bi, k0:k0 + m, hi] = sum(acc_k[1:], acc_k[0])[:m] * scale
            for q0 in range(0, s, BQ):                   # dQ: a CTA a query tile
                sl, rows = slice(q0, q0 + BQ), torch.arange(q0, q0 + BQ)
                acc_q = [torch.zeros(BQ, d) for _ in range(ks_dq)]
                kv_end = min(skv, q0 + BQ) if causal else skv
                kv_begin = max(0, q0 - window + 1) // BKV * BKV if window > 0 else 0
                for k0 in range(kv_begin, kv_end, BKV):
                    kt, vt = kk[k0:k0 + BKV], vv[k0:k0 + BKV]
                    _, dx = _p_dx(mm(qh[sl], kt.T), mm(doh[sl], vt.T), lh[sl], eh[sl], rows,
                                  torch.arange(k0, k0 + BKV), s, skv,
                                  _edge(q0, k0, s, skv, causal, window), scale, causal, window,
                                  softcap)
                    split_product(dx, kt, acc_q, ks_dq)
                m = min(BQ, s - q0)
                dq[bi, q0:q0 + m, hi] = (sum(acc_q[1:], acc_q[0]) * scale)[:m]
    fold = lambda t: t.reshape(b, skv, kh, h // kh, d).sum(3)   # noqa: E731
    return dq, fold(dkh), fold(dvh)


def _jax_grads(q, k, v, do, h, **kw):
    """jax.vjp of repro.kernels.ref.attention_ref, k and v expanded over each
    kv head's query heads; at S_kv != S (unmasked) of the model's attention,
    ``repro.nn.attention.attend_ref(kind="bidir")``."""
    b, s, _, d = q.shape
    skv = k.shape[1]

    def attn(q, k, v):
        if skv != s:
            rep = lambda x: jnp.repeat(x, h // x.shape[2], 2)   # noqa: E731
            pos = lambda n: jnp.broadcast_to(jnp.arange(n), (b, n))   # noqa: E731
            return jattention.attend_ref(q, rep(k), rep(v), pos(s), pos(skv), kind="bidir",
                                         scale=kw["scale"], softcap=kw["softcap"])
        fold = lambda x: jnp.repeat(x, h // x.shape[2], 2).transpose(0, 2, 1, 3).reshape(
            b * h, s, d)                    # noqa: E731
        return jref.attention_ref(fold(q), fold(k), fold(v), **kw).reshape(
            b, h, s, d).transpose(0, 2, 1, 3)
    # one compiled program: faster on the CPU than the vjp's ops one by one
    grads = jax.jit(lambda q, k, v, do: jax.vjp(attn, q, k, v)[1](do))
    return grads(*(jnp.asarray(x) for x in (q, k, v, do)))


def _rel_err(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


CASES = {
    "gqa10_d256": (1, 64, 10, 1, 256, {}),
    "d16_window_in_tile": (2, 64, 2, 1, 16, {"window": 20}),
    "d64_window_in_tile": (1, 96, 2, 2, 64, {"window": 40}),
    "softcap": (1, 64, 2, 1, 64, {"softcap": 5.0}),
    "non_causal": (1, 50, 2, 1, 16, {"causal": False}),
    "ragged_s": (1, 77, 4, 2, 64, {}),
    # k and v of a length of their own (unmasked): fewer and more keys than
    # queries, each ragged against the 32-key tiles
    "kv_longer": (1, 40, 4, 2, 64, {"causal": False, "skv": 100}),
    "kv_shorter": (2, 70, 2, 1, 16, {"causal": False, "skv": 33}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tile_walk_matches_jax_vjp_and_plain(case):
    b, s, h, kh, d, kw = CASES[case]
    kw = {"causal": True, "window": 0, "softcap": None, **kw}
    skv = kw.pop("skv", s)
    scale = d ** -0.5
    rng = np.random.default_rng(17)
    q, do = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, skv, kh, d)).astype(np.float32) for _ in range(2))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o = ops.flash_attention_plain(tq, tk, tv, scale=scale, **kw)
    lse = ops.flash_attention_lse_plain(tq, tk, scale=scale, **kw)
    got = _tile_walk(tq, tk, tv, o, lse, tdo, scale=scale, mm=mm_3xtf32, **kw)
    plain = ops.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, scale=scale, **kw)
    jgrads = _jax_grads(q, k, v, do, h, scale=scale, causal=kw["causal"], window=kw["window"],
                        softcap=kw["softcap"])
    errs = []
    for name, g, p, j in zip(("dq", "dk", "dv"), got, plain, jgrads):
        assert g.shape == p.shape
        errs.append(max(_rel_err(g, p), _rel_err(g, j)))
        assert errs[-1] <= GRAD_TOL, f"{name}: {errs[-1]:.2e} of max |g|"
    if case == "gqa10_d256":
        # one TF32 product a multiply (10-bit mantissas) misses by far more
        one = _tile_walk(tq, tk, tv, o, lse, tdo, scale=scale, mm=mm_tf32, **kw)
        one_errs = [_rel_err(g, j) for g, j in zip(one, jgrads)]
        assert all(e1 >= 10 * e3 for e1, e3 in zip(one_errs, errs)), (one_errs, errs)


def test_tf32_rounding_is_rna():
    """The emulated cvt.rna.tf32.f32 keeps 10 mantissa bits, rounds to
    nearest with ties away from zero, and leaves the low 13 bits zero."""
    one_ulp = 2.0 ** -10
    x = torch.tensor([1.0 + one_ulp / 2, -(1.0 + one_ulp / 2), 1.0 + one_ulp / 2 - 2.0 ** -23,
                      3.0, 1.0 + 3 * one_ulp / 4])
    want = torch.tensor([1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 3.0, 1.0 + one_ulp])
    assert torch.equal(tf32(x), want)
    assert not bool((tf32(torch.randn(1000)).view(torch.int32) & 0x1FFF).any())


@pytest.mark.parametrize("s,skv,h,kh,d", [(12, 40, 4, 2, 16),    # S < S_kv, GQA 2:1
                                          (40, 12, 4, 4, 16),    # S > S_kv
                                          (24, 64, 8, 2, 64),    # D 64, GQA 4:1
                                          (65, 33, 2, 1, 64)])   # S > S_kv, one kv head
def test_bwd_plain_kv_len_matches_attend_ref(s, skv, h, kh, d):
    """K1-bwd's plain version with k and v of a length of their own
    (cross-attention: no mask) against jax.vjp of the model's attention,
    ``repro.nn.attention.attend_ref(kind="bidir")``, and autograd of the
    port's plain forward: 1e-5 of each gradient's max. A causal mask or a
    window with such a length raises."""
    b, scale = 2, d ** -0.5
    rng = np.random.default_rng(18)
    q, do = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, skv, kh, d)).astype(np.float32) for _ in range(2))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    kw = {"causal": False, "scale": scale}
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    o = ops.flash_attention_plain(*leaves, **kw)
    auto = torch.autograd.grad(o, leaves, tdo)
    lse = ops.flash_attention_lse_plain(tq, tk, **kw)
    plain = ops.flash_attention_bwd_plain(tq, tk, tv, o.detach(), lse, tdo, **kw)
    jgrads = _jax_grads(q, k, v, do, h, scale=scale, causal=False, window=0, softcap=None)
    for name, p, a, j in zip(("dq", "dk", "dv"), plain, auto, jgrads):
        assert p.shape == (b, s if name == "dq" else skv, h if name == "dq" else kh, d)
        assert max(_rel_err(p, a), _rel_err(p, j)) <= 1e-5, name
    for bad in ({"causal": True}, {"causal": False, "window": 4}):
        with pytest.raises(ValueError, match="no causal mask"):
            ops.flash_attention_bwd_plain(tq, tk, tv, o.detach(), lse, tdo, **bad)
