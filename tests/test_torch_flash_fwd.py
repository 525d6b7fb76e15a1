"""K1's 3xTF32 route (``csrc/flash_attention.cu``, ``flash_tf32x3_kernel``),
emulated on the CPU, against the JAX package's Pallas kernel in interpret
mode and the port's plain versions of the output and the log-sum-exp.

The emulation walks the kernel's tiles (BQ query rows by BK keys, read
from the ``.cu``): a CTA of BQ rows visits only the key tiles that are not
wholly above its diagonal or outside its window, masks only the tiles that
cross the diagonal, the window's edge or S (keys past S at -inf, masked
ones at -1e30), and updates the online softmax once a tile in the kernel's
order: the row max over the tile, P = exp(s - m_new), the sum and the
accumulator rescaled by exp(m_old - m_new), then O += P V, whose k-splits
(the warps' shares of a tile's keys at D 16, as the ``.cu``'s ``Cfg<D>``
splits them) are summed apart and added in order at the end. Both products
are taken as the kernel takes them on ``mma.sync``: 3xTF32, from
``test_torch_flash_bwd``. bf16 inputs are widened to fp32 (exactly) and the
output rounded to bf16. Held at the card tests' tolerances: the output at
2e-5 (bf16 2e-2), the log-sum-exp at 1e-5; one case also walks with single
TF32 products, whose error is at least 10x larger.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from test_torch_flash_bwd import mm_3xtf32, mm_tf32  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LSE_TOL = 1e-5
CU = Path(ops.__file__).resolve().parent / "csrc" / "flash_attention.cu"


def _route_constants():
    """BQ and BK of the .cu's 3xTF32 route (its namespace x3)."""
    src = CU.read_text()
    body = src[src.index("namespace x3 {"):src.index("}  // namespace x3")]
    return {name: int(re.search(rf"^constexpr int {name} = (\d+);", body, re.M).group(1))
            for name in ("BQ", "BK")}


C = _route_constants()
BQ, BK = C["BQ"], C["BK"]


def _k_splits(d):
    """The .cu's Cfg<D>::KS: the O product's n-blocks NB = min(4, D / 8)
    take 2 NB of the CTA's 8 warps, and the rest split the tile's keys."""
    return 4 // min(4, d // 8)


def _edge(q0, k0, s, causal, window, skv=None):
    """The .cu's edge_tile(q0, k0, S, ...) || k0 + BK > S_kv."""
    skv = s if skv is None else skv
    return (q0 + BQ > s or k0 + BK > s or (causal and k0 + BK - 1 > q0)
            or (window > 0 and q0 + BQ - 1 - k0 >= window) or k0 + BK > skv)


def _tile_walk(q, k, v, *, scale, causal, window, softcap, mm):
    """(out in q's dtype, lse fp32 (B,H,S)) by the 3xTF32 route's tile walk
    with products `mm`; k and v may have a length of their own, S_kv."""
    b, s, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    n = -(-max(s, skv) // BQ) * BQ
    pad = lambda x: torch.cat([x, x.new_zeros(n - x.shape[0], *x.shape[1:])])   # noqa: E731
    qf, kf, vf = q.float(), k.float(), v.float()
    ks = _k_splits(d)
    out = torch.zeros(b, s, h, d)
    lse = torch.zeros(b, h, s)
    for bi in range(b):
        for hi in range(h):
            kvh = hi // (h // kh)
            qh, kk, vv = pad(qf[bi, :, hi]), pad(kf[bi, :, kvh]), pad(vf[bi, :, kvh])
            for q0 in range(0, s, BQ):
                rows = torch.arange(q0, q0 + BQ)
                m = torch.full((BQ,), -1e30)
                l = torch.zeros(BQ)
                acc = [torch.zeros(BQ, d) for _ in range(ks)]
                kv_end = min(skv, q0 + BQ) if causal else skv
                kv_begin = max(0, q0 - window + 1) // BK * BK if window > 0 else 0
                for k0 in range(kv_begin, kv_end, BK):
                    cols = torch.arange(k0, k0 + BK)
                    x = mm(qh[q0:q0 + BQ], kk[k0:k0 + BK].T) * scale
                    if softcap:
                        x = softcap * torch.tanh(x / softcap)
                    if _edge(q0, k0, s, causal, window, skv):
                        ok = torch.ones(BQ, BK, dtype=torch.bool)
                        if causal:
                            ok &= cols[None] <= rows[:, None]
                        if window > 0:
                            ok &= (rows[:, None] - cols[None]) < window
                        x = torch.where(ok, x, torch.tensor(-1e30))
                        x = torch.where(cols[None] >= skv, torch.tensor(-torch.inf), x)
                    m_new = torch.maximum(m, x.max(-1).values)
                    corr = torch.exp(m - m_new)
                    p = torch.exp(x - m_new[:, None])
                    l = l * corr + p.sum(-1)
                    for j in range(ks):
                        c = slice(j * BK // ks, (j + 1) * BK // ks)
                        acc[j] = acc[j] * corr[:, None] + mm(p[:, c].contiguous(),
                                                             vv[k0:k0 + BK][c])
                    m = m_new
                den = l.clamp_min(1e-30)
                nq = min(BQ, s - q0)
                out[bi, q0:q0 + nq, hi] = (sum(acc[1:], acc[0]) / den[:, None])[:nq]
                lse[bi, hi, q0:q0 + nq] = (m + torch.log(den))[:nq]
    return out.to(q.dtype), lse


def _pallas(q, k, v, h, block, **kw):
    """The Pallas K1 in interpret mode, k and v expanded over each kv head's
    query heads (its wrapper takes no GQA)."""
    rep = lambda x: jnp.repeat(jnp.asarray(x), h // x.shape[2], axis=2)   # noqa: E731
    return jops.flash_attention(jnp.asarray(q), rep(k), rep(v), block_q=block, block_k=block,
                                **kw)


CASES = {
    # b, s, h, kh, d, dtype, options, Pallas block (dividing S)
    "d16_s33": (2, 33, 2, 1, 16, torch.float32, {}, 33),
    "d16_window_in_tile": (1, 77, 4, 1, 16, torch.float32, {"window": 7}, 77),
    "d64_s77_gqa": (1, 77, 4, 2, 64, torch.float32, {}, 77),
    "d64_softcap": (1, 77, 2, 2, 64, torch.float32, {"softcap": 30.0}, 77),
    "d64_non_causal": (1, 33, 2, 1, 64, torch.float32, {"causal": False}, 33),
    "d128_s300_window_in_tile": (1, 300, 2, 1, 128, torch.float32, {"window": 45}, 100),
    "d256_s300": (1, 300, 2, 1, 256, torch.float32, {}, 100),
    "d256_gqa10": (1, 77, 10, 1, 256, torch.float32, {"window": 2048}, 77),
    "bf16_d16": (1, 77, 4, 2, 16, torch.bfloat16, {"window": 20, "softcap": 5.0}, 77),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tf32x3_tile_walk_matches_pallas_and_plain(case):
    b, s, h, kh, d, dtype, kw, block = CASES[case]
    kw = {"causal": True, "window": 0, "softcap": None, **kw}
    scale = d ** -0.5
    rng = np.random.default_rng(23)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, kh, d)).astype(np.float32) for _ in range(2))
    if dtype == torch.bfloat16:   # the same bf16 values on both sides
        q, k, v = (torch.from_numpy(x).bfloat16().float().numpy() for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    out, lse = _tile_walk(tq, tk, tv, scale=scale, mm=mm_3xtf32, **kw)
    assert out.dtype == dtype and out.shape == (b, s, h, d) and lse.shape == (b, h, s)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = _pallas(*(x.astype(jdt) for x in (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))),
                   h, block, **kw)
    plain = ops.flash_attention_plain(tq, tk, tv, scale=scale, **kw)
    tol = TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(out, plain, atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ops.flash_attention_lse_plain(tq, tk, scale=scale, **kw),
                               atol=LSE_TOL, rtol=LSE_TOL)
    if case == "d256_gqa10":
        # one TF32 product a multiply (10-bit mantissas) misses by far more
        one, _ = _tile_walk(tq, tk, tv, scale=scale, mm=mm_tf32, **kw)
        err3, err1 = ((x - plain).abs().max().item() for x in (out, one))
        assert err1 >= 10 * err3 and err1 > tol, (err1, err3)


@pytest.mark.parametrize("s,skv,h,kh,d,dtype", [
    (12, 8, 4, 2, 16, torch.float32),      # the reduced encoder-decoder's cross call
    (100, 70, 4, 2, 64, torch.float32),    # S_kv < S, ragged in its last key tile
    (33, 300, 2, 1, 128, torch.float32),   # S_kv > S over ten key tiles
    (50, 77, 4, 2, 16, torch.bfloat16),
])
def test_tf32x3_tile_walk_kv_len(s, skv, h, kh, d, dtype):
    """The 3xTF32 route with k and v of a length of their own (the
    encoder-decoder's cross-attention, no mask): the walk stops at S_kv and
    masks the last key tile's columns past it; output and log-sum-exp
    against the plain versions."""
    rng = np.random.default_rng(s * skv)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
               for shape in ((2, s, h, d), (2, skv, kh, d), (2, skv, kh, d)))
    kw = dict(scale=d ** -0.5, causal=False, window=0, softcap=None)
    out, lse = _tile_walk(q, k, v, mm=mm_3xtf32, **kw)
    assert out.shape == (2, s, h, d) and lse.shape == (2, h, s)
    tol = TOL[dtype]
    torch.testing.assert_close(out, ops.flash_attention_plain(q, k, v, **kw), atol=tol, rtol=tol)
    kw.pop("scale")
    torch.testing.assert_close(lse, ops.flash_attention_lse_plain(q, k, scale=d ** -0.5, **kw),
                               atol=LSE_TOL, rtol=LSE_TOL)
