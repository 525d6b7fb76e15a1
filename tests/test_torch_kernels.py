"""The port's attention ops (plain PyTorch versions on the CPU) against the
JAX package's Pallas kernels in interpret mode, on the same numpy inputs.

Mirrors the sweep of tests/test_kernels.py at its tolerances (fp32 2e-5,
bf16 2e-2), plus what the port adds: a ragged S, a length-0 decode row and
GQA caches that are not head-expanded; and the tile walk of K1's
tensor-core route, emulated in PyTorch, against the Pallas kernel.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import decode_attention as tdecode  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(JDT[dtype]) for a in arrs],
            [torch.from_numpy(a).to(TDT[dtype]) for a in arrs])


def _close(t, j, dtype):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("s,d,dtype", [(128, 64, "float32"),
                                       (256, 128, "float32"),
                                       (128, 64, "bfloat16")])
@pytest.mark.parametrize("window,softcap", [(0, None), (64, None), (0, 30.0)])
def test_flash_attention_plain_matches_pallas(s, d, dtype, window, softcap):
    b, h = 2, 2
    (jq, jk, jv), (tq, tk, tv) = _inputs(7, [(b, s, h, d)] * 3, dtype)
    want = jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                softcap=softcap, block_q=64, block_k=64)
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window,
                              softcap=softcap)
    assert got.dtype == TDT[dtype] and got.shape == (b, s, h, d)
    _close(got, want, dtype)


def _wgmma_walk(q, k, v, *, scale, causal, window, softcap):
    """K1's tensor-core route as a tile walk: a CTA of 64 query rows loads
    only the KV tiles of BK keys (32 at D <= 128, 64 at D 256) that are not
    wholly above its diagonal or outside its window, masks only the tiles
    that cross its diagonal, its window's edge or S_kv, keeps the running
    max and sum in fp32, and multiplies P rounded to bf16 by V. Inputs q
    (B,S,H,D), k and v (B,S_kv,KH,D) with KH dividing H; returns q's
    dtype."""
    b, s, h, d = q.shape
    skv = k.shape[1]
    bq, bk = 64, (64 if d > 128 else 32)
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.zeros(b, s, h, d)
    for bi in range(b):
        for hi in range(h):
            kvh = hi // (h // k.shape[2])
            for q0 in range(0, s, bq):
                r = torch.arange(q0, q0 + bq)
                nq = min(bq, s - q0)
                qt = torch.zeros(bq, d)
                qt[:nq] = qf[bi, q0:q0 + nq, hi]
                m = torch.full((bq,), -1e30)
                l = torch.zeros(bq)
                acc = torch.zeros(bq, d)
                kv_end = min(skv, q0 + bq) if causal else skv
                kv_begin = max(0, q0 - window + 1) // bk * bk if window > 0 else 0
                for k0 in range(kv_begin, kv_end, bk):
                    c = torch.arange(k0, k0 + bk)
                    nk = min(bk, skv - k0)
                    kt, vt = torch.zeros(bk, d), torch.zeros(bk, d)
                    kt[:nk], vt[:nk] = kf[bi, k0:k0 + nk, kvh], vf[bi, k0:k0 + nk, kvh]
                    x = (qt @ kt.T) * scale
                    if softcap:
                        x = softcap * torch.tanh(x / softcap)
                    if ((causal and k0 + bk - 1 > q0) or (window > 0 and q0 + bq - 1 - k0 >= window)
                            or k0 + bk > skv):
                        ok = torch.ones(bq, bk, dtype=torch.bool)
                        if causal:
                            ok &= c[None] <= r[:, None]
                        if window > 0:
                            ok &= (r[:, None] - c[None]) < window
                        x = torch.where(ok, x, torch.tensor(-1e30))
                        x = torch.where(c[None] >= skv, torch.tensor(-torch.inf), x)
                    m_new = torch.maximum(m, x.max(-1).values)
                    corr = torch.exp(m - m_new)
                    p = torch.exp(x - m_new[:, None])
                    l = l * corr + p.sum(-1)
                    acc = acc * corr[:, None] + p.to(torch.bfloat16).float() @ vt
                    m = m_new
                out[bi, q0:q0 + nq, hi] = (acc / l.clamp_min(1e-30)[:, None])[:nq]
    return out.to(q.dtype)


@pytest.mark.parametrize("s,d,causal,window,softcap", [
    (128, 64, True, 0, None),
    (256, 128, True, 0, None),
    (256, 64, True, 100, None),      # window edges inside tiles; tiles skipped
    (256, 128, True, 0, 30.0),
    (128, 128, True, 48, 30.0),
    (256, 256, True, 70, None),      # D 256: 64-key tiles
    (128, 64, False, 0, None),
])
def test_wgmma_tile_walk_matches_pallas(s, d, causal, window, softcap):
    """The tensor-core route's design (64-row query tiles, BK-key tiles,
    tile skipping, edge-only masks, P rounded to bf16 before PV, fp32
    rescaling) against the Pallas kernel in interpret mode at bf16's 2e-2."""
    b, h = 1, 2
    (jq, jk, jv), (tq, tk, tv) = _inputs(13, [(b, s, h, d)] * 3, "bfloat16")
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                softcap=softcap, block_q=64, block_k=64)
    got = _wgmma_walk(tq, tk, tv, scale=d ** -0.5, causal=causal, window=window,
                      softcap=softcap)
    assert got.dtype == torch.bfloat16
    _close(got, want, "bfloat16")


@pytest.mark.parametrize("s,skv,h,kh,d", [
    (12, 8, 2, 2, 64),        # the reduced encoder-decoder's shape, under one tile
    (100, 70, 4, 2, 64),      # S_kv < S, ragged in its last key tile
    (70, 300, 2, 1, 128),     # S_kv > S over ten key tiles, the last ragged
    (65, 129, 2, 2, 256),     # BK 64: one key past two tiles
])
def test_wgmma_tile_walk_kv_len(s, skv, h, kh, d):
    """The tensor-core route with k and v of a length of their own (the
    encoder-decoder's cross-attention, no mask): the walk stops at S_kv and
    masks the last key tile's columns past it; against the plain version at
    bf16's 2e-2."""
    rng = np.random.default_rng(s + skv)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
               for shape in ((1, s, h, d), (1, skv, kh, d), (1, skv, kh, d)))
    got = _wgmma_walk(q, k, v, scale=d ** -0.5, causal=False, window=0, softcap=None)
    want = ops.flash_attention_plain(q, k, v, causal=False, scale=d ** -0.5)
    assert got.shape == want.shape == (1, s, h, d)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dtype,d", [(dt, d) for dt in (torch.float32, torch.bfloat16)
                                     for d in tflash.HEAD_DIMS])
def test_flash_route_rule(dtype, d):
    """bf16 at D 64/128/256 takes wgmma; fp32 at every D and bf16 at D 16
    take 3xTF32 mma.sync (one TF32 product would miss fp32's 2e-5)."""
    want = "wgmma" if dtype == torch.bfloat16 and d in (64, 128, 256) else "tf32x3"
    assert tflash.route(dtype, d) == want


def test_reset_clears_flash_route_counts():
    tflash.flash_attention.launches_by_route["wgmma"] += 3
    tflash.flash_attention.launches += 3
    ops.reset_launch_counts()
    assert tflash.flash_attention.launches_by_route == {"wgmma": 0, "tf32x3": 0}
    assert ops.launch_counts()["flash_attention"] == 0


def _fold(x):
    b, s, h, d = x.shape
    return jnp.moveaxis(x, 2, 1).reshape(b * h, s, d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_ragged_gqa(dtype):
    """S = 77 (no block divides it) and 2 kv heads for 6 query heads: the
    oracle sees the head-expanded KV, the port the unexpanded one."""
    b, s, h, kh, d = 2, 77, 6, 2, 32
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        11, [(b, s, h, d), (b, s, kh, d), (b, s, kh, d)], dtype)
    rep = lambda x: _fold(jnp.repeat(x, h // kh, axis=2))
    want = jref.attention_ref(_fold(jq), rep(jk), rep(jv), scale=0.1)
    got = ops.flash_attention(tq, tk, tv, scale=0.1)
    got = got.transpose(1, 2).reshape(b * h, s, d)
    _close(got, want, dtype)


@pytest.mark.parametrize("s,dtype", [(256, "float32"), (512, "bfloat16")])
def test_decode_attention_plain_matches_pallas(s, dtype):
    b, h, d = 3, 4, 64
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        5, [(b, h, d), (b, s, h, d), (b, s, h, d)], dtype)
    lens = np.array([s // 4, s // 2, s], np.int32)
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(lens), block_s=128)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    assert got.dtype == TDT[dtype] and got.shape == (b, h, d)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_empty_row_ragged_gqa(dtype):
    """A length-0 row (the mean of all S cached V rows), a length past S, a
    ragged S = 200 and an unexpanded GQA cache (5 query heads per kv head,
    as qwen3-14b)."""
    b, s, h, kh, d = 4, 200, 10, 2, 32
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        3, [(b, h, d), (b, s, kh, d), (b, s, kh, d)], dtype)
    lens = np.array([0, 1, 137, 999], np.int32)
    rep = lambda x: jnp.repeat(x, h // kh, axis=2)
    want = jref.decode_attention_ref(jq, rep(jk), rep(jv), jnp.asarray(lens))
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    _close(got, want, dtype)
    mean_v = tv[0].float().mean(0).repeat_interleave(h // kh, dim=0)
    torch.testing.assert_close(got[0].float(), mean_v, atol=TOL[dtype],
                               rtol=TOL[dtype])


_PLAN_PARAMS = ("b", "s", "h", "kh", "d", "dtype", "num_sms")


@pytest.mark.parametrize("shape,want", [
    ((4, 512, 40, 8, 128, "bfloat16"), (32, 16)),    # qwen3-14b's decode call: 512 CTAs
    ((4, 512, 48, 8, 128, "bfloat16"), (32, 16)),    # at tp 16: 48 padded heads, a group of 6
    ((4, 576, 10, 1, 256, "bfloat16"), (16, 36)),    # recurrentgemma-2b's: 144 CTAs
    ((1, 576, 10, 1, 256, "float32"), (16, 36)),     # B 1: no chunk gives 264 CTAs
    ((1, 16, 4, 2, 64, "float32"), (16, 1)),         # S of 16 or less: one split
    ((2, 1, 4, 4, 16, "bfloat16"), (16, 1)),
    ((64, 4096, 32, 8, 128, "bfloat16"), (256, 16)),  # CTAs to spare: the largest chunk
    ((3, 333, 8, 8, 64, "float32"), (32, 11)),      # 264 CTAs exactly
    ((2, 200, 10, 2, 32, "float32"), (16, 13)),
    ((1, 64, 512, 1, 256, "float32"), ValueError),   # q alone overflows shared memory
] + [((64, 8192, 8 * g, 8, d, dt), None)              # every (dtype, D) K2 takes
     for dt in TDT for d in (16, 64, 128, 256) for g in (1, 10, 64)])
def test_decode_plan(shape, want):
    """K2's plan is a function of shapes alone (so a captured call replays
    at any lengths): chunk a power of two >= 16, splits * chunk >= S, the
    CTA within shared memory, the largest chunk that gives 2 * SMs CTAs,
    and at the serving calls at least 132 CTAs at 132 SMs."""
    import inspect
    b, s, h, kh, d, dt = shape
    assert tuple(inspect.signature(tdecode.plan).parameters) == _PLAN_PARAMS
    if want is ValueError:
        with pytest.raises(ValueError, match="shared memory"):
            tdecode.plan(b, s, h, kh, d, TDT[dt], 132)
        return
    chunk, splits = tdecode.plan(b, s, h, kh, d, TDT[dt], 132)
    tdecode.plan.cache_clear()
    assert tdecode.plan(b, s, h, kh, d, TDT[dt], 132) == (chunk, splits)
    if want is not None:
        assert (chunk, splits) == want
    assert chunk >= 16 and chunk & (chunk - 1) == 0
    assert splits * chunk >= s > (splits - 1) * chunk
    esz = TDT[dt].itemsize
    assert tdecode.smem_bytes(chunk, h // kh, d, esz) <= tdecode.SMEM_MAX
    if b * kh * splits < 2 * 132:   # a smaller chunk could not do better and fit
        assert chunk == 16
    bigger = 2 * chunk
    if bigger <= max(16, 1 << (s - 1).bit_length()) and bigger in tdecode.CHUNKS and \
            tdecode.smem_bytes(bigger, h // kh, d, esz) <= tdecode.SMEM_MAX:
        assert b * kh * -(-s // bigger) < 2 * 132
    if shape[:5] in ((4, 512, 40, 8, 128), (4, 576, 10, 1, 256)):
        assert b * kh * splits >= 132


def _kernel_smem_rule():
    """SMEM_MAX, MIN_CHUNK and smem_bytes as decode_attention.cu defines
    them, the C expression evaluated in Python."""
    src = (Path(tdecode.__file__).parent / "csrc" / "decode_attention.cu").read_text()
    const = dict(re.findall(r"constexpr int (SMEM_MAX|MIN_CHUNK) = (\d+);", src))
    body = re.search(r"long smem_bytes\(int chunk, int G, int D, int esz\) \{\s*"
                     r"return (.*?);\s*\}", src, re.S).group(1)
    expr = compile(re.sub(r"\(long\)|(?<=\d)L\b", "", " ".join(body.split())),
                   "smem_bytes", "eval")
    return (int(const["SMEM_MAX"]), int(const["MIN_CHUNK"]),
            lambda chunk, g, d, esz: eval(expr, {}, dict(chunk=chunk, G=g, D=d, esz=esz)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 64, 128, 256])
def test_decode_smem_rule_matches_kernel(dtype, d):
    """The plan's shared-memory rule is the kernel's: smem_bytes, SMEM_MAX
    and the smallest chunk in decode_attention.py equal those of the .cu,
    so a chunk the plan picks is one the C entry point accepts."""
    smem_max, min_chunk, kernel_bytes = _kernel_smem_rule()
    assert tdecode.SMEM_MAX == smem_max and tdecode.CHUNKS[0] == min_chunk
    esz = TDT[dtype].itemsize
    for chunk in tdecode.CHUNKS:
        for g in (1, 5, 10, 64, 183, 2408):
            assert tdecode.smem_bytes(chunk, g, d, esz) == kernel_bytes(chunk, g, d, esz)


def _split_s(q, k, v, lengths, *, chunk, scale, softcap=None, return_lse=False):
    """K2's two passes in PyTorch, fp32 inside: for each live split (one
    whose chunk starts before the row's length n), the logits of its valid
    positions (capped to softcap * tanh(s / softcap) with `softcap`; all
    -1e30 on a length-0 row, where n = S), m, l = sum exp(s - m) and the
    unnormalised acc; a dead split's partials stay NaN, so a combine that
    read one would show it. The combine reads only the ceil(n / chunk) live
    splits. With `return_lse`, (the output in fp32, M + log L), the combine
    pass's running max M and sum L giving each row's log-sum-exp."""
    b, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    splits = -(-s // chunk)
    kf = k.float().repeat_interleave(h // kh, 2)
    vf = v.float().repeat_interleave(h // kh, 2)
    part = torch.full((splits, b, h, d + 2), float("nan"))
    out, lse = torch.empty(b, h, d), torch.empty(b, h)
    for bi in range(b):
        ln = int(lengths[bi])
        n = s if ln <= 0 else min(ln, s)
        for sp in range(splits):
            p0 = sp * chunk
            if p0 >= n:
                continue
            rows = slice(p0, min(p0 + chunk, n))
            logits = torch.einsum("hd,phd->hp", q[bi].float(), kf[bi, rows]) * scale
            if softcap:
                logits = softcap * torch.tanh(logits / softcap)
            if ln <= 0:
                logits = torch.full_like(logits, -1e30)
            m = logits.max(-1).values
            e = torch.exp(logits - m[:, None])
            part[sp, bi, :, :d] = torch.einsum("hp,phd->hd", e, vf[bi, rows])
            part[sp, bi, :, d], part[sp, bi, :, d + 1] = m, e.sum(-1)
        live = part[:-(-n // chunk), bi]
        mx = live[..., d].max(0).values
        w = torch.exp(live[..., d] - mx)
        den = (w * live[..., d + 1]).sum(0)
        out[bi] = (w[..., None] * live[..., :d]).sum(0) / den.clamp_min(1e-30)[:, None]
        lse[bi] = mx + torch.log(den)
    return (out, lse) if return_lse else out.to(q.dtype)


@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,h,kh,d", [(256, 4, 4, 64),     # expanded: the Pallas kernel
                                      (200, 10, 2, 32),    # ragged S, 5 heads a kv head
                                      (200, 10, 1, 64),    # 10 heads a kv head
                                      (200, 12, 2, 32)])   # 6 a kv head (qwen3-14b at tp 16)
def test_decode_split_s_matches_pallas(chunk, dtype, s, h, kh, d):
    """K2's split-S design, emulated, against the JAX package: lengths 0
    (the mean of all S V rows), 1 (only split 0 live), a chunk's edge, one
    past it, and past S. The expanded cache goes through the Pallas kernel
    as test_decode_attention_plain_matches_pallas runs it, a GQA cache
    through the oracle on the expanded cache."""
    b = 5
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        13, [(b, h, d), (b, s, kh, d), (b, s, kh, d)], dtype)
    lens = np.array([0, 1, chunk, chunk + 1, 999], np.int32)
    if kh == h:
        want = jops.decode_attention(jq, jk, jv, jnp.asarray(lens), block_s=128)
    else:
        rep = lambda x: jnp.repeat(x, h // kh, axis=2)
        want = jref.decode_attention_ref(jq, rep(jk), rep(jv), jnp.asarray(lens))
    got = _split_s(tq, tk, tv, torch.from_numpy(lens), chunk=chunk, scale=d ** -0.5)
    assert got.dtype == TDT[dtype] and got.shape == (b, h, d)
    _close(got, want, dtype)


@pytest.mark.parametrize("chunk", [16, 32])
def test_decode_split_s_softcap_matches_attend_ref(chunk):
    """K2's split-S design with gemma2's cap of 50 taken in the split pass,
    before the running max, emulated, against the JAX model's decode
    (``attend_ref`` with the softcap, a global cache masked by position) on
    a GQA cache of 10 query heads on 2 kv heads: lengths 0, 1, a chunk's
    edge, one past it and past S. q is scaled so that the logits reach
    about 40 a standard deviation and the cap bends them. In fp32: in bf16
    ``attend_ref`` rounds the logits to bf16 (its einsum's output dtype)
    before the cap, which K2 and its plain version do not."""
    from repro.nn.attention import attend_ref
    b, s, h, kh, d, dtype = 5, 200, 10, 2, 32, "float32"
    (jq, jk, jv), (tq, tk, tv) = _inputs(17, [(b, h, d), (b, s, kh, d), (b, s, kh, d)], dtype)
    jq, tq = jq * 40, tq * 40
    lens = np.array([0, 1, chunk, chunk + 1, 999], np.int32)
    rep = lambda x: jnp.repeat(x, h // kh, axis=2)   # noqa: E731
    want = attend_ref(jq[:, None], rep(jk), rep(jv), jnp.asarray(lens - 1)[:, None],
                      jnp.broadcast_to(jnp.arange(s), (b, s)), scale=d ** -0.5,
                      softcap=50.0)[:, 0]
    got = _split_s(tq, tk, tv, torch.from_numpy(lens), chunk=chunk, scale=d ** -0.5,
                   softcap=50.0)
    _close(got, want, dtype)
    plain = ops.decode_attention_plain(tq, tk, tv, torch.from_numpy(lens), scale=d ** -0.5,
                                       softcap=50.0)
    _close(plain, want, dtype)
    uncapped = _split_s(tq, tk, tv, torch.from_numpy(lens), chunk=chunk, scale=d ** -0.5)
    assert float((uncapped.float() - got.float()).abs().max()) > 10 * TOL[dtype]


# the outputs' tolerance by input dtype; the log-sum-exp is fp32 arithmetic
# on the same values in either dtype, so it is held at 1e-5 in both
OUT_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LSE_TOL = 1e-5


def _jax_decode(jq, jk, jv, lens, *, h, kh, scale, softcap=None):
    """The reference's decode in JAX, fp32 inside: the output and the
    log-sum-exp (``jax.nn.logsumexp``) of the masked (and capped) logits,
    over the cache expanded to the query heads as ``jnp.repeat`` does."""
    import jax
    rep = lambda x: jnp.repeat(x, h // kh, axis=2).astype(jnp.float32)   # noqa: E731
    logits = jnp.einsum("bhd,bshd->bhs", jq.astype(jnp.float32), rep(jk)) * scale
    if softcap:
        logits = softcap * jnp.tanh(logits / softcap)
    ok = jnp.arange(jk.shape[1])[None, None, :] < jnp.asarray(lens)[:, None, None]
    logits = jnp.where(ok, logits, -1e30)
    out = jnp.einsum("bhs,bshd->bhd", jax.nn.softmax(logits, axis=-1), rep(jv))
    return out, jax.nn.logsumexp(logits, axis=-1)


@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["expanded", "gqa", "softcap"])
def test_decode_lse_matches_jax(case, dtype, chunk):
    """K2 with the log-sum-exp, on the CPU: the plain version
    (``ops.decode_attention(..., return_lse=True)``: an fp32 output and an
    fp32 log-sum-exp) and the emulated split-S passes (``_split_s``, whose
    log-sum-exp is the combine's M + log L) against the JAX package, at
    lengths 0 (every logit masked: the mean of all S V rows, log-sum-exp
    -1e30), 1, a chunk's edge, one past it and S. The output against the
    Pallas kernel in interpret mode on an expanded cache, against
    ``decode_attention_ref`` on a GQA cache of 6 query heads a kv head
    (qwen3-14b's group at tp 16), and with gemma2's cap of 50 (q scaled so
    that the cap bends the logits) against ``attend_ref`` in fp32; every
    output and log-sum-exp also against the masked logits' softmax and
    ``jax.nn.logsumexp`` in JAX. fp32 at 1e-5; bf16 inputs at the file's
    bf16 tolerance for the outputs (fp32 either way) and at 1e-5 for the
    log-sum-exp, which is fp32 arithmetic on the same values."""
    s, h, kh, d, softcap = {"expanded": (256, 4, 4, 64, None), "gqa": (200, 12, 2, 32, None),
                            "softcap": (200, 10, 2, 32, 50.0)}[case]
    b, scale, tol = 5, d ** -0.5, OUT_TOL[dtype]
    (jq, jk, jv), (tq, tk, tv) = _inputs(19, [(b, h, d), (b, s, kh, d), (b, s, kh, d)], dtype)
    if softcap:
        jq, tq = jq * 40, tq * 40
    lens = np.array([0, 1, chunk, chunk + 1, s], np.int32)
    out, lse = ops.decode_attention(tq, tk, tv, torch.from_numpy(lens), scale=scale,
                                    softcap=softcap, return_lse=True)
    assert out.dtype == lse.dtype == torch.float32
    assert out.shape == (b, h, d) and lse.shape == (b, h)
    emu_out, emu_lse = _split_s(tq, tk, tv, torch.from_numpy(lens), chunk=chunk, scale=scale,
                                softcap=softcap, return_lse=True)
    want_out, want_lse = _jax_decode(jq, jk, jv, lens, h=h, kh=kh, scale=scale,
                                     softcap=softcap)
    if case == "expanded":
        ref = jops.decode_attention(jq, jk, jv, jnp.asarray(lens), block_s=128)
    elif case == "gqa":
        rep = lambda x: jnp.repeat(x, h // kh, axis=2)   # noqa: E731
        ref = jref.decode_attention_ref(jq, rep(jk), rep(jv), jnp.asarray(lens))
    elif dtype == "float32":   # attend_ref rounds bf16 logits to bf16 before the cap
        from repro.nn.attention import attend_ref
        rep = lambda x: jnp.repeat(x, h // kh, axis=2)   # noqa: E731
        ref = attend_ref(jq[:, None], rep(jk), rep(jv), jnp.asarray(lens - 1)[:, None],
                         jnp.broadcast_to(jnp.arange(s), (b, s)), scale=scale,
                         softcap=softcap)[:, 0]
    else:
        ref = want_out
    for got_out, got_lse in ((out, lse), (emu_out, emu_lse)):
        for want in (ref, want_out):
            np.testing.assert_allclose(got_out.numpy(), np.asarray(want, np.float32),
                                       atol=tol, rtol=tol)
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=LSE_TOL,
                                   rtol=LSE_TOL)
    neg = float(np.float32(-1e30))   # the masked logit plus log S, in fp32
    assert float(lse[0].max()) == float(emu_lse[0].max()) == neg
    assert float(np.asarray(want_lse)[0].max()) == neg
    mean_v = tv[0].float().mean(0).repeat_interleave(h // kh, dim=0)
    torch.testing.assert_close(out[0], mean_v, atol=tol, rtol=tol)
    # without the log-sum-exp: the same output, rounded once to q's dtype
    assert torch.equal(ops.decode_attention(tq, tk, tv, torch.from_numpy(lens), scale=scale,
                                            softcap=softcap), out.to(tq.dtype))


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never fall back: a CPU tensor is an error there,
    and the ops dispatch refuses inputs split across devices."""
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        tdecode.decode_attention(q[:, 0], q, q, torch.ones(1, dtype=torch.int32))
    assert ops.launch_counts() == {"flash_attention": 0, "decode_attention": 0,
                                   "ssd_scan": 0, "rglru_scan": 0, "flash_attention_bwd": 0,
                                   "ssd_scan_bwd": 0, "rglru_scan_bwd": 0}
    meta = torch.zeros(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="all be on the CPU or all on CUDA"):
        ops.flash_attention(q, meta, q)


def test_wrappers_check_shapes_before_launch():
    q = torch.zeros(1, 8, 3, 16)
    kv = torch.zeros(1, 8, 2, 16)     # 2 kv heads do not divide 3 q heads
    with pytest.raises(ValueError, match="do not match"):
        tflash.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="head_dim"):
        tflash.flash_attention(torch.zeros(1, 8, 2, 24), torch.zeros(1, 8, 2, 24),
                               torch.zeros(1, 8, 2, 24))
    with pytest.raises(ValueError, match="lengths"):
        tdecode.decode_attention(torch.zeros(2, 2, 16), torch.zeros(2, 8, 2, 16),
                                 torch.zeros(2, 8, 2, 16), torch.ones(2))


def test_build_paths_track_source_and_flags(monkeypatch, tmp_path):
    """A library is named by a hash of its source and flags, under
    build/kernels/ of the checkout, so an edited source is never served
    by a stale build; without nvcc, building raises instead of falling back."""
    from repro_torch.kernels import build
    for name in build.KERNELS:
        assert (build.CSRC / f"{name}.cu").is_file()
        path = build.library_path(name)
        assert path.parent == build.BUILD_DIR and path.name.startswith(f"lib{name}-")
        assert build.BUILD_DIR.parts[-2:] == ("build", "kernels")
    before = build.library_path("flash_attention")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path("flash_attention") != before
    # an edited header renames every library that includes it, directly or
    # through another header, and only those
    assert build.headers("flash_attention") == [build.CSRC / "hopper.cuh",
                                                build.CSRC / "mma_tf32.cuh"]
    assert build.headers("flash_attention_bwd") == build.headers("flash_attention")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in (*build.CSRC.glob("*.cu"), *build.CSRC.glob("*.cuh")):
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    for header, includers in (("mma_tf32.cuh", {"flash_attention", "flash_attention_bwd",
                                                "ssd_scan", "ssd_scan_bwd"}),
                              ("ssd_tf32.cuh", {"ssd_scan", "ssd_scan_bwd"}),
                              ("hopper.cuh", {"flash_attention", "flash_attention_bwd",
                                              "decode_attention", "ssd_scan", "ssd_scan_bwd"})):
        paths = {name: build.library_path(name) for name in build.KERNELS}
        with open(csrc / header, "a") as f:
            f.write("// edited\n")
        for name in build.KERNELS:
            changed = build.library_path(name) != paths[name]
            assert changed == (csrc / header in build.headers(name)), name
        assert {n for n in build.KERNELS if csrc / header in build.headers(n)} == includers
    # a header reached only through another header counts too
    (csrc / "only_nested.cu").write_text('#include "mma_tf32.cuh"\n')
    assert build.headers("only_nested") == [csrc / "hopper.cuh", csrc / "mma_tf32.cuh"]
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(("decode_attention",))
