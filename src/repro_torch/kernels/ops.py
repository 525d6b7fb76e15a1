"""Public wrappers for the kernels, dispatching on the device.

Mirrors ``repro.kernels.ops`` and keeps its signatures and its (B,S,H,D)
layout. A CPU tensor takes the plain PyTorch version; a CUDA tensor
launches the hand-written kernel or raises — there is no fallback.
Unlike the JAX wrappers, k and v may keep fewer heads than q (GQA, KH
dividing H), and the SSD scan's b and c may keep fewer groups than x has
heads: the kernels read them unexpanded, and the plain versions expand
them first. ``scale`` defaults to D**-0.5, as in the JAX package. The
RG-LRU scan takes an initial state and returns the last one, which the
Pallas kernel does not, because the model needs both.
"""

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import rglru_scan as _rglru
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels.ref import attention_ref, decode_attention_ref, rglru_ref

KERNELS = {"flash_attention": _flash.flash_attention,
           "decode_attention": _decode.decode_attention,
           "ssd_scan": _ssd.ssd_scan,
           "rglru_scan": _rglru.rglru_scan}


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts():
    """Zero every kernel's count, and K1's and K3's counts by route."""
    for fn in KERNELS.values():
        fn.launches = 0
    _flash.flash_attention.launches_by_route = dict.fromkeys(_flash.ROUTES, 0)
    _ssd.ssd_scan.launches_by_route = dict.fromkeys(_ssd.ROUTES, 0)


def _expand_kv(k, n_heads):
    """(B,S,KH,D) -> (B,S,H,D), kv head j serving query heads j*H/KH ..
    (j+1)*H/KH - 1, as jnp.repeat(axis=2). A broadcast and copy: unlike
    repeat_interleave it never synchronises with the device."""
    b, s, kh, d = k.shape
    if n_heads == kh:
        return k
    return k[:, :, :, None].expand(b, s, kh, n_heads // kh, d).reshape(b, s, n_heads, d)


def _on_cpu(*ts) -> bool:
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"inputs must all be on the CPU or all on CUDA; got {devs}")


def flash_attention_plain(q, k, v, *, causal=True, window=0, softcap=None,
                          scale=None):
    """Plain PyTorch version of `flash_attention` (any device)."""
    b, s, h, d = q.shape
    fold = lambda x: x.transpose(1, 2).reshape(b * h, s, d)
    out = attention_ref(fold(q), fold(_expand_kv(k, h)), fold(_expand_kv(v, h)),
                        scale=scale, causal=causal, window=window,
                        softcap=softcap)
    return out.reshape(b, h, s, d).transpose(1, 2)


def flash_attention(q, k, v, *, causal=True, window=0, softcap=None, scale=None):
    """(B,S,H,D) q; (B,S,KH,D) k, v with KH dividing H. -> (B,S,H,D)."""
    if _on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    return _flash.flash_attention(q, k, v, scale=scale, causal=causal,
                                  window=window, softcap=softcap)


def decode_attention_plain(q, k, v, lengths, *, scale=None):
    """Plain PyTorch version of `decode_attention` (any device)."""
    h = q.shape[1]
    return decode_attention_ref(q, _expand_kv(k, h), _expand_kv(v, h), lengths,
                                scale=scale)


def decode_attention(q, k, v, lengths, *, scale=None):
    """q (B,H,D); k,v (B,S,KH,D) with KH dividing H; lengths (B,)."""
    if _on_cpu(q, k, v, lengths):
        return decode_attention_plain(q, k, v, lengths, scale=scale)
    return _decode.decode_attention(q, k, v, lengths, scale=scale)


def ssd_scan_plain(x, dt, a, b, c, *, chunk=128, h0=None):
    """Plain PyTorch version of `ssd_scan` (any device): the chunked SSD
    algorithm of ``repro.nn.ssd.ssd_chunked``, with its dtypes. The C·Bᵀ
    scores and the inter-chunk product C·S_prev are taken in the input
    dtype (S_prev cast to it first), everything else in fp32.

    x (B,S,H,P); dt (B,S,H) post-softplus, fp32; a (H,) negative, fp32;
    b, c (B,S,G,N) with G dividing H; h0 (B,H,P,N) fp32 or None.
    Returns (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) fp32)."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
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
    y_intra = torch.einsum("bchlm,bcmhp->bclhp", m, xc.float())

    # chunk summary states: S_c = sum_s exp(cs_last - cs_s) dt_s x_s B_s
    w = torch.exp(seg_total[..., None, :] - cs) * dtc     # (B,nc,L,H)
    s_chunk = torch.einsum("bclh,bclhp,bclhn->bchpn", w, xc.float(), bc.float())

    # inter-chunk recurrence, then y_t += exp(cs_t) C_t . S_{c-1}
    seg = torch.exp(seg_total)
    state = h0 if h0 is not None else torch.zeros((bsz, h, p, n), dtype=torch.float32,
                                                  device=x.device)
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
    else:
        y, state = _ssd.ssd_scan(x, dt, a, b, c, h0=h0, return_state=return_state)
    return (y, state) if return_state else y


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
    return _rglru.rglru_scan(a, b, h0=h0, out_dtype=out_dtype)
