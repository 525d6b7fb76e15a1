"""Public wrappers for the kernels, dispatching on the device.

Mirrors ``repro.kernels.ops`` and keeps its signatures and its (B,S,H,D)
layout. A CPU tensor takes the plain PyTorch version (so does a meta
tensor, which holds a shape and no values: the dry run's); a CUDA tensor
launches the hand-written kernel or raises — there is no fallback.
Unlike the JAX wrappers, k and v may keep fewer heads than q (GQA, KH
dividing H), and the SSD scan's b and c may keep fewer groups than x has
heads: the kernels read them unexpanded, and the plain versions expand
them first. ``scale`` defaults to D**-0.5, as in the JAX package. The
RG-LRU scan takes an initial state and returns the last one, which the
Pallas kernel does not, because the model needs both.

Gradients: on the CPU, autograd differentiates the plain versions. On the
card, K1 and K3 in fp32 and in bf16, and K4 (fp32 a and b, whatever the
compute dtype), run as autograd Functions whose backward is a kernel too
(K1-bwd, K3-bwd, K4-bwd), each of the forward's dtype: bf16 K1 at head_dim
64, 128 and 256 pairs its wgmma route, which writes the log-sum-exp, with
K1-bwd's bf16 route, bf16 K1 at head_dim 16 its 3xTF32 route with K1-bwd's
3xTF32 kernels on bf16, and bf16 K3 (any route) with K3-bwd's bf16 route,
so the models train on the card at the reference's production dtypes (bf16
params and compute, full remat), the smoke configs (head_dim 16) too:

    train.setup(arch, param_dtype="bfloat16", compute_dtype="bfloat16",
                remat="full", num_layers=...)

K1-bwd takes k and v of a length of their own, as K1 does. A kernel with
no backward kernel for its inputs (K2; K1 at a dtype or head_dim that
``bwd_route`` gives no route) raises
NotImplementedError when grad mode is on and an input requires a gradient
(``needs_grad``), rather than return a tensor with no ``grad_fn``, which
would leave every parameter upstream of it without a gradient and no
error. ``flash_attention_bwd_plain``, ``flash_attention_bwd_bf16_plain``
(with the bf16 kernel's roundings), ``ssd_scan_bwd_plain`` and
``rglru_scan_bwd_plain`` are the backward kernels' plain versions, written
out as the passes each kernel runs, for the tests and ``chip_smoke.py``;
nothing on the card's path calls them. On the CPU the production dtypes
are held to the JAX package by ``tests/test_torch_bf16_train.py`` (one
train step, the plain backward versions against ``jax.vjp``), and the
guard by ``tests/test_torch_train.py::test_grad_guard_predicate``.
"""

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import rglru_scan as _rglru
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels.ref import NEG_INF, attention_ref, decode_attention_ref, rglru_ref

KERNELS = {"flash_attention": _flash.flash_attention,
           "decode_attention": _decode.decode_attention,
           "ssd_scan": _ssd.ssd_scan,
           "rglru_scan": _rglru.rglru_scan,
           "flash_attention_bwd": _flash.flash_attention_bwd,
           "ssd_scan_bwd": _ssd.ssd_scan_bwd,
           "rglru_scan_bwd": _rglru.rglru_scan_bwd}


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts():
    """Zero every kernel's count, K2's count of launches with the
    log-sum-exp, and K1's, K1-bwd's, K3's and K3-bwd's counts by route."""
    for fn in KERNELS.values():
        fn.launches = 0
    _decode.decode_attention.launches_with_lse = 0
    _flash.flash_attention.launches_by_route = dict.fromkeys(_flash.ROUTES, 0)
    _flash.flash_attention_bwd.launches_by_route = dict.fromkeys(_flash.BWD_ROUTES, 0)
    _ssd.ssd_scan.launches_by_route = dict.fromkeys(_ssd.ROUTES, 0)
    _ssd.ssd_scan_bwd.launches_by_route = dict.fromkeys(_ssd.BWD_ROUTES, 0)


def needs_grad(*ts) -> bool:
    """Whether autograd would record a call on `ts` (None entries skipped):
    grad mode is on and some input requires a gradient."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


def _no_backward(what, queue):
    return NotImplementedError(
        f"{what} has no backward kernel yet, so it cannot run on the card with an input "
        f"that requires a gradient (ROADMAP.md queue 1: {queue}); run it under "
        "torch.no_grad(), or on the CPU, where autograd differentiates its plain version")


def _expand_kv(k, n_heads):
    """(B,S,KH,D) -> (B,S,H,D), kv head j serving query heads j*H/KH ..
    (j+1)*H/KH - 1, as jnp.repeat(axis=2). A broadcast and copy: unlike
    repeat_interleave it never synchronises with the device."""
    b, s, kh, d = k.shape
    if n_heads == kh:
        return k
    return k[:, :, :, None].expand(b, s, kh, n_heads // kh, d).reshape(b, s, n_heads, d)


def _on_cpu(*ts) -> bool:
    """Whether the plain version runs: inputs on the CPU, or on the meta
    device (shapes only: the dry run); on CUDA the kernel runs."""
    if any(isinstance(t, DTensor) for t in ts):
        raise TypeError("a kernel wrapper takes local tensors, not DTensors: call it on each "
                        "rank's shards (local_map or to_local())")
    devs = {t.device.type for t in ts}
    if devs in ({"cpu"}, {"meta"}):
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"inputs must all be on the CPU or all on CUDA; got {devs}")


def flash_attention_plain(q, k, v, *, causal=True, window=0, softcap=None,
                          scale=None):
    """Plain PyTorch version of `flash_attention` (any device)."""
    b, s, h, d = q.shape
    fold = lambda x: x.transpose(1, 2).reshape(b * h, x.shape[1], d)   # noqa: E731
    out = attention_ref(fold(q), fold(_expand_kv(k, h)), fold(_expand_kv(v, h)),
                        scale=scale, causal=causal, window=window,
                        softcap=softcap)
    return out.reshape(b, h, s, d).transpose(1, 2)


def flash_attention(q, k, v, *, causal=True, window=0, softcap=None, scale=None):
    """(B,S,H,D) q; (B,S_kv,KH,D) k, v with KH dividing H. -> (B,S,H,D).
    S_kv differs from S only without `causal` and `window` (the
    encoder-decoder's cross-attention), and raises otherwise."""
    _flash.check_kv_len(q, k, causal, window)
    if _on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    if needs_grad(q, k, v):
        if _flash.bwd_route(q.dtype, q.shape[-1]) is None:
            raise _no_backward(f"K1 in {q.dtype} at head_dim {q.shape[-1]}",
                               "a K1 backward at this dtype and head_dim")
        return _flash.FlashAttention.apply(q, k, v, scale, causal, window, softcap)
    return _flash.flash_attention(q, k, v, scale=scale, causal=causal,
                                  window=window, softcap=softcap)


def flash_attention_lse_plain(q, k, *, causal=True, window=0, softcap=None, scale=None):
    """Each row's log-sum-exp (B,H,S) fp32 of the scaled, capped, masked
    logits of `flash_attention` (scores of q and k as given, in fp32): what
    both its routes write for the backward."""
    b, s, h, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), _expand_kv(k, h).float()) * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    ok = _mask(s, causal, window, q.device, k.shape[1])
    return torch.logsumexp(torch.where(ok, logits, NEG_INF), dim=-1)


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal=True, window=0, softcap=None,
                              scale=None):
    """Plain PyTorch version of K1-bwd: (dq, dk, dv) of `flash_attention`
    from its inputs, output o, log-sum-exp lse (B,H,S) and the output's
    gradient do, by the formulas the kernel computes, in fp32 (fp64 for
    fp64 inputs) whatever the inputs' dtype, returned in q's dtype:
    P = exp(t - lse), dT = P (dO.V - Delta) with Delta = dO.O,
    dX = dT (1 - tanh^2(x / cap)), dq = scale dX K, dk = scale dX^T Q,
    dv = P^T dO; dk and dv summed over each kv head's query heads. k and v
    may have S_kv rows of their own, unmasked, as in `flash_attention`."""
    return _flash_bwd(q, k, v, o, lse, do, causal=causal, window=window, softcap=softcap,
                      scale=scale, round_to=None)


def flash_attention_bwd_bf16_plain(q, k, v, o, lse, do, *, causal=True, window=0,
                                   softcap=None, scale=None):
    """Plain PyTorch version of K1-bwd's bf16 route, with its roundings: as
    `flash_attention_bwd_plain` on bf16 q, k, v, o and do, but P and dX
    rounded to bf16 before the products that take them (dv = P^T dO, dq =
    scale dX K, dk = scale dX^T Q), as the kernel rounds them for its bf16
    tensor-core products; the products' sums in fp32, dq, dk and dv
    rounded to bf16 once (dk and dv after the sum over a kv head's query
    heads)."""
    return _flash_bwd(q, k, v, o, lse, do, causal=causal, window=window, softcap=softcap,
                      scale=scale, round_to=torch.bfloat16)


def _flash_bwd(q, k, v, o, lse, do, *, causal, window, softcap, scale, round_to):
    """The formulas of `flash_attention_bwd_plain`; `round_to` (a dtype or
    None) rounds P and dX before the products that take them."""
    _flash.check_kv_len(q, k, causal, window)
    b, s, h, d = q.shape
    kh, s_kv = k.shape[2], k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    acc = torch.promote_types(q.dtype, torch.float32)
    qf, dof, of = q.to(acc), do.to(acc), o.to(acc)
    kf, vf = _expand_kv(k, h).to(acc), _expand_kv(v, h).to(acc)
    rnd = (lambda t: t) if round_to is None else (lambda t: t.to(round_to).to(acc))  # noqa: E731
    x = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    dxdt = 1.0
    if softcap:
        th = torch.tanh(x / softcap)
        x, dxdt = softcap * th, 1.0 - th * th
    ok = _mask(s, causal, window, q.device, s_kv)
    p = torch.exp(torch.where(ok, x, NEG_INF) - lse[..., None])    # 0 where masked
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * of).sum(-1).transpose(1, 2)                      # (B,H,S)
    dx = rnd(p * (dp - delta[..., None]) * dxdt)
    dq = torch.einsum("bhqk,bkhd->bqhd", dx, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", dx, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", rnd(p), dof)
    fold = lambda t: t.reshape(b, s_kv, kh, h // kh, d).sum(3).to(q.dtype)   # noqa: E731
    return dq.to(q.dtype), fold(dk), fold(dv)


def _mask(s, causal, window, device, s_kv=None):
    s_kv = s if s_kv is None else s_kv
    rows = torch.arange(s, device=device)[:, None]
    cols = torch.arange(s_kv, device=device)[None, :]
    ok = torch.ones((s, s_kv), dtype=torch.bool, device=device)
    if causal:
        ok &= cols <= rows
    if window:
        ok &= (rows - cols) < window
    return ok


def decode_attention_plain(q, k, v, lengths, *, scale=None, softcap=None, return_lse=False):
    """Plain PyTorch version of `decode_attention` (any device), with
    `return_lse` too: (out fp32, lse fp32), what a rank holding one chunk
    of a sequence-sharded cache (`lengths` valid slots from its start)
    contributes to the combine over the ranks."""
    h = q.shape[1]
    return decode_attention_ref(q, _expand_kv(k, h), _expand_kv(v, h), lengths,
                                scale=scale, softcap=softcap, return_lse=return_lse)


def decode_attention(q, k, v, lengths, *, scale=None, softcap=None, return_lse=False):
    """q (B,H,D); k,v (B,S,KH,D) with KH dividing H; lengths (B,). `softcap`
    caps the scaled logits (gemma2), which the Pallas kernel does not.
    Returns (B,H,D) in q's dtype; with `return_lse`, (out (B,H,D) fp32,
    log-sum-exp (B,H) fp32 of each row's valid logits)."""
    if _on_cpu(q, k, v, lengths):
        return decode_attention_plain(q, k, v, lengths, scale=scale, softcap=softcap,
                                      return_lse=return_lse)
    if needs_grad(q, k, v):
        raise _no_backward("K2 (decode attention)", "decode is served under no_grad; "
                           "no training path decodes")
    return _decode.decode_attention(q, k, v, lengths, scale=scale, softcap=softcap,
                                    return_lse=return_lse)


def ssd_scan_plain(x, dt, a, b, c, *, chunk=128, h0=None):
    """Plain PyTorch version of `ssd_scan` (any device): the chunked SSD
    algorithm of ``repro.nn.ssd.ssd_chunked``, with its dtypes. The C·Bᵀ
    scores and the inter-chunk product C·S_prev are taken in the input
    dtype (S_prev cast to it first), everything else in fp32 (fp64 for
    fp64 inputs, an oracle's).

    x (B,S,H,P); dt (B,S,H) post-softplus, fp32; a (H,) negative, fp32;
    b, c (B,S,G,N) with G dividing H; h0 (B,H,P,N) fp32 or None.
    Returns (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) fp32)."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    acc = torch.promote_types(x.dtype, torch.float32)
    pad = -s % chunk
    if pad:
        x, b, c = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, b, c))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    nc = x.shape[1] // chunk
    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    bc = b.reshape(bsz, nc, chunk, g, n).repeat_interleave(h // g, dim=3)
    cc = c.reshape(bsz, nc, chunk, g, n).repeat_interleave(h // g, dim=3)

    cs = torch.cumsum(dtc * a, dim=2)                     # (B,nc,L,H)
    seg_total = cs[:, :, -1]                              # (B,nc,H)

    # intra-chunk: M[t,s] = (C_t . B_s) * exp(cs_t - cs_s) * dt_s for s <= t;
    # the mask goes in before exp, since exp(cs_t - cs_s) overflows for s > t
    scores = torch.einsum("bclhn,bcmhn->bchlm", cc, bc)
    decay = (cs[..., :, None, :] - cs[..., None, :, :]).movedim(-1, 2)   # (B,nc,H,L,L)
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    m = scores * torch.exp(torch.where(causal, decay, -torch.inf)) \
        * dtc.movedim(-1, 2)[..., None, :]
    y_intra = torch.einsum("bchlm,bcmhp->bclhp", m, xc.to(acc))

    # chunk summary states: S_c = sum_s exp(cs_last - cs_s) dt_s x_s B_s
    w = torch.exp(seg_total[..., None, :] - cs) * dtc     # (B,nc,L,H)
    s_chunk = torch.einsum("bclh,bclhp,bclhn->bchpn", w, xc.to(acc), bc.to(acc))

    # inter-chunk recurrence, then y_t += exp(cs_t) C_t . S_{c-1}
    seg = torch.exp(seg_total)
    state = h0 if h0 is not None else torch.zeros((bsz, h, p, n), dtype=acc, device=x.device)
    prev = []
    for ci in range(nc):
        prev.append(state)
        state = seg[:, ci, :, None, None] * state + s_chunk[:, ci]
    prev_states = torch.stack(prev, dim=1)               # (B,nc,H,P,N)
    y_inter = torch.einsum("bclhn,bchpn->bclhp", cc, prev_states.to(cc.dtype)) \
        * torch.exp(cs)[..., None]
    y = (y_intra + y_inter).reshape(bsz, nc * chunk, h, p)[:, :s]
    return y.to(x.dtype), state


def ssd_scan(x, dt, a, b, c, *, chunk=128, h0=None, return_state=False):
    """Mamba2 SSD scan. x (B,S,H,P); dt (B,S,H) fp32, post-softplus; a (H,)
    fp32, negative; b, c (B,S,G,N), G dividing H (G == H is the JAX
    wrapper's head-expanded layout); h0 (B,H,P,N) fp32 or None (zeros).
    Returns y, or (y, final_state) with `return_state`. `chunk` steers only
    the plain version: the kernel picks its own chunk length, and the
    result is the same up to rounding."""
    if _on_cpu(x, dt, a, b, c, *(() if h0 is None else (h0,))):
        y, state = ssd_scan_plain(x, dt, a, b, c, chunk=chunk, h0=h0)
    elif needs_grad(x, dt, a, b, c, h0):
        if x.dtype not in _ssd.DTYPES:
            raise _no_backward(f"K3 in {x.dtype}", "a K3 backward at this dtype")
        y, state = _ssd.SSDScan.apply(x, dt, a, b, c, h0)
    else:
        y, state = _ssd.ssd_scan(x, dt, a, b, c, h0=h0, return_state=return_state)
    return (y, state) if return_state else y


def ssd_scan_bwd_plain(x, dt, a, b, c, h0, dy, dstate, *, chunk=_ssd.CHUNK):
    """Plain PyTorch version of K3-bwd: (dx, ddt, da, db, dc, dh0) of
    `ssd_scan` (y, final_state) given the gradients dy (B,S,H,P) and dstate
    (B,H,P,N) (or None: zeros), in fp32 (fp64 for fp64 inputs, an
    oracle's) whatever the dtype of x, b, c and dy; dx, db and dc are
    returned in x's dtype (bf16 on the bf16 route), the rest fp32 (fp64).
    By the passes the kernel runs over chunks of `chunk` steps (the
    kernel's own, 64):
    1. state recompute: each chunk's incoming state S_{c-1}, by the
       forward's recurrence S_c = exp(cs_L) S_{c-1} + sum_s w_s x_s B_s^T,
       w_s = exp(cs_L - cs_s) dt_s, from h0 (or zeros);
    2. the reverse state-gradient scan, seeded with dstate:
       dS_{c-1} = exp(cs_L) dS_c + sum_t exp(cs_t) dy_t^T C_t; its last
       value is dh0;
    3. per chunk, with M[t,s] = (C_t . B_s) exp(cs_t - cs_s) dt_s for
       s <= t (masked before exp), dM[t,s] = dy_t . x_s and dS = dS_c:
       dx_s = sum_t M[t,s] dy_t + w_s dS B_s,
       dC_t = sum_s dG[t,s] B_s + exp(cs_t) dy_t S_{c-1},
       dB_s = sum_t dG[t,s] C_t + w_s x_s dS, with dG = dM exp(cs_t - cs_s) dt_s;
       d(cs) from the decays (R = dM (C_t . B_s) exp(cs_t - cs_s)), the
       carried terms and exp(cs_L), then a reverse cumsum within the chunk
       to d(dt a): ddt = its a-multiple plus the direct terms, da its sum
       against dt. db and dc sum over each group's heads; dh0 is None when
       h0 is."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    acc, out_dtype = torch.promote_types(x.dtype, torch.float32), x.dtype
    f = lambda t: None if t is None else t.to(acc)   # noqa: E731
    x, dt, a, b, c, h0, dy, dstate = map(f, (x, dt, a, b, c, h0, dy, dstate))
    pad = -s % chunk
    if pad:
        x, b, c, dy = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, b, c, dy))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    nc = x.shape[1] // chunk
    xc, dyc = (t.reshape(bsz, nc, chunk, h, p) for t in (x, dy))
    dtc = dt.reshape(bsz, nc, chunk, h)
    bc, cc = (t.reshape(bsz, nc, chunk, g, n).repeat_interleave(h // g, dim=3) for t in (b, c))
    cs = torch.cumsum(dtc * a, dim=2)                          # (B,nc,L,H)
    cl = cs[:, :, -1]                                          # (B,nc,H)
    ecs = torch.exp(cs)
    w = torch.exp(cl[:, :, None] - cs) * dtc                   # (B,nc,L,H)

    # 1. the state entering each chunk
    s_chunk = torch.einsum("bclh,bclhp,bclhn->bchpn", w, xc, bc)
    state = torch.zeros((bsz, h, p, n), dtype=acc, device=x.device) if h0 is None else h0
    prev = []
    for ci in range(nc):
        prev.append(state)
        state = torch.exp(cl[:, ci])[..., None, None] * state + s_chunk[:, ci]
    prev = torch.stack(prev, dim=1)                            # (B,nc,H,P,N)

    # 2. the gradient of the state each chunk leaves, in reverse
    carried = torch.einsum("bclh,bclhp,bclhn->bchpn", ecs, dyc, cc)
    ds = torch.zeros_like(state) if dstate is None else dstate
    after = [None] * nc
    for ci in range(nc - 1, -1, -1):
        after[ci] = ds
        ds = torch.exp(cl[:, ci])[..., None, None] * ds + carried[:, ci]
    after = torch.stack(after, dim=1)                          # (B,nc,H,P,N)

    # 3. each chunk's gradients
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    decay = (cs[..., :, None, :] - cs[..., None, :, :]).movedim(-1, 2)   # (B,nc,H,t,s)
    e = torch.exp(torch.where(causal, decay, -torch.inf))
    dt_s = dtc.movedim(-1, 2)[..., None, :]                    # dt_s along the last axis
    gm = torch.einsum("bclhn,bcmhn->bchlm", cc, bc)            # C_t . B_s
    dm = torch.einsum("bclhp,bcmhp->bchlm", dyc, xc)           # dy_t . x_s
    m = gm * e * dt_s
    r = dm * gm * e
    dg = dm * e * dt_s
    u = torch.einsum("bcmhn,bchpn->bcmhp", bc, after)          # dS B_s
    dx = torch.einsum("bchlm,bclhp->bcmhp", m, dyc) + w[..., None] * u
    dw = (xc * u).sum(-1)                                      # (B,nc,L,H)
    z = torch.einsum("bclhp,bchpn->bclhn", dyc, prev)          # dy_t S_{c-1}
    dcm = torch.einsum("bchlm,bcmhn->bclhn", dg, bc) + ecs[..., None] * z
    dbm = torch.einsum("bchlm,bclhn->bcmhn", dg, cc) \
        + w[..., None] * torch.einsum("bcmhp,bchpn->bcmhn", xc, after)
    col = r.sum(-2).movedim(-1, 2)                             # sum_t R[t,s]: (B,nc,L,H)
    dcs = (r * dt_s).sum(-1).movedim(-1, 2) - dtc * col + ecs * (cc * z).sum(-1) - dw * w
    dcs[:, :, -1] += (dw * w).sum(2) + torch.exp(cl) * (after * prev).sum((-2, -1))
    rc = dcs.flip(2).cumsum(2).flip(2)                         # sum over u >= t
    ddt = col + dw * torch.exp(cl[:, :, None] - cs) + a * rc
    da = (dtc * rc).sum((0, 1, 2))

    def steps(t):
        return t.reshape(bsz, nc * chunk, *t.shape[3:])[:, :s]
    group = lambda t: steps(t).reshape(bsz, s, g, h // g, n).sum(3).to(out_dtype)  # noqa: E731
    return (steps(dx).to(out_dtype), steps(ddt), da, group(dbm), group(dcm),
            (None if h0 is None else ds))


def rglru_scan_plain(a, b, *, h0=None, out_dtype=torch.float32):
    """Plain PyTorch version of `rglru_scan` (any device): ``rglru_ref``'s
    loop over S with an fp32 carry, each h_t rounded once to `out_dtype`."""
    y, h_last = rglru_ref(a, b, h0)
    return y.to(out_dtype), h_last


def rglru_scan(a, b, *, h0=None, out_dtype=torch.float32):
    """h_t = a_t * h_{t-1} + b_t. a, b (B,S,W) fp32; h0 (B,W) fp32 or None
    (zeros). Returns (y (B,S,W) in `out_dtype`, h_last (B,W) fp32)."""
    if _on_cpu(a, b, *(() if h0 is None else (h0,))):
        return rglru_scan_plain(a, b, h0=h0, out_dtype=out_dtype)
    if needs_grad(a, b, h0):
        return _rglru.RGLRUScan.apply(a, b, h0, out_dtype)
    return _rglru.rglru_scan(a, b, h0=h0, out_dtype=out_dtype)


def rglru_scan_bwd_plain(a, y, h0, dy, dh_last):
    """Plain PyTorch version of K4-bwd: (da, db, dh0) of `rglru_scan` from
    a, its fp32 h sequence y, h0 (or None: zeros) and the gradients dy and
    dh_last (or None: zeros), by the reverse recurrence the kernel runs:
    g_t = dy_t + a_{t+1} g_{t+1} (g_{S-1} = dy_{S-1} + dh_last), db_t = g_t,
    da_t = g_t h_{t-1}, dh0 = a_0 g_0. dh0 is None when h0 is."""
    bsz, s, w = a.shape
    g = torch.zeros((bsz, w), dtype=torch.float32, device=a.device) if dh_last is None \
        else dh_last.float()
    a_next = torch.ones_like(g)
    da, db = torch.empty_like(y), torch.empty_like(y)
    h_init = torch.zeros_like(g) if h0 is None else h0.float()
    for t in range(s - 1, -1, -1):
        g = dy[:, t] + a_next * g
        db[:, t] = g
        da[:, t] = g * (y[:, t - 1] if t else h_init)
        a_next = a[:, t]
    return da, db, (None if h0 is None else a_next * g)
