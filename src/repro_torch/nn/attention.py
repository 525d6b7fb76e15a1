"""Multi-head attention with GQA, qkv biases, qk-norm, local windows,
softcaps and a KV cache.

Mirrors ``repro.nn.attention``. Prefill goes through ``ops.flash_attention``
(K1) and one-token decode through ``ops.decode_attention`` (K2); on the card
both are the hand-written CUDA kernels, on the CPU their plain versions.
Both read the unexpanded GQA cache, so no head-expanded copy is built, and
both cap the scaled logits with ``cfg.attn_softcap`` (gemma2) before the
mask, as the JAX model's ``attend_ref`` does.

A local (sliding-window) layer keeps a ring cache of min(max_len, window)
slots, position p at slot p % size, as the JAX package does; RecurrentGemma
and gemma2's local layers use it. A "bidir" attention (the encoder's) is
unmasked, K1 without its causal mask, and keeps no cache. Cross-attention
(the encoder-decoder's decoder: queries from the text, fixed K/V from the
encoder's output, no rope) goes through K1 with k and v of a length of
their own in the prefill and through K2 with every cached frame valid in
decode.

The cache is updated in place (the JAX serve step donates it, so the
memory behaviour is the same); each call also returns the cache it wrote.
"""

from typing import Optional

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.nn import init as inits
from repro_torch.nn.norms import Norm, apply_norm
from repro_torch.nn.rope import apply_rope


class Attention(nn.Module):
    """wq (d,H,hd), wk/wv (d,K,hd), wo (H,hd,d), the biases bq (H,hd) and
    bk/bv (K,hd) with `cfg.qkv_bias`, qk-norm scales: the JAX package's
    layout. (Padded heads come with the sharding slice.)"""

    def __init__(self, cfg, *, gen=None, dtype=torch.float32, device="cpu"):
        super().__init__()
        d, h, k, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

        def mk(shape, init):
            return nn.Parameter(init(gen, shape, dtype, device), requires_grad=False)
        self.wq = mk((d, h, hd), inits.fan_in())
        self.wk = mk((d, k, hd), inits.fan_in())
        self.wv = mk((d, k, hd), inits.fan_in())
        self.wo = mk((h, hd, d), inits.fan_in(in_axes=(0, 1)))
        self.bq = self.bk = self.bv = None
        if cfg.qkv_bias:
            self.bq = mk((h, hd), inits.zeros)
            self.bk = mk((k, hd), inits.zeros)
            self.bv = mk((k, hd), inits.zeros)
        kw = dict(kind=cfg.norm, gen=gen, dtype=dtype, device=device)
        self.q_norm = Norm(hd, **kw) if cfg.qk_norm else None
        self.k_norm = Norm(hd, **kw) if cfg.qk_norm else None


def _check_kind(kind, kinds=("global", "local")):
    if kind not in kinds:
        raise NotImplementedError(f"attention kind {kind!r} is not ported yet")


def _proj(x, w):
    """x (B,S,d) @ w (d,N,hd) -> (B,S,N,hd), contiguous."""
    b, s, _ = x.shape
    return (x @ w.to(x.dtype).reshape(w.shape[0], -1)).view(b, s, w.shape[1], w.shape[2])


def _out_proj(out, wo):
    """out (B,S,H,hd) @ wo (H,hd,d) -> (B,S,d)."""
    b, s = out.shape[:2]
    return out.reshape(b, s, -1) @ wo.to(out.dtype).reshape(-1, wo.shape[-1])


def qkv_project(cfg, p, x):
    """x (B,S,d) -> q (B,S,H,hd), k,v (B,S,K,hd), with rope NOT yet applied.
    The biases, then qk-norm, come before rope, as in the JAX package."""
    q, k, v = _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)
    if p.bq is not None:
        dt = x.dtype
        q, k, v = q + p.bq.to(dt), k + p.bk.to(dt), v + p.bv.to(dt)
    if p.q_norm is not None:
        q = apply_norm(p.q_norm, q, cfg.norm_eps)
        k = apply_norm(p.k_norm, k, cfg.norm_eps)
    return q, k, v


def attention(cfg, p, x, positions, *, kind="global",
              cache: Optional[dict] = None):
    """Prefill attention over a full sequence: causal ("global", "local"
    with its window) or unmasked ("bidir", which takes no cache).

    Returns (out (B,S,d), the filled cache entry or None). If `cache` is
    given, the rope-rotated k and raw v are written into it.
    """
    _check_kind(kind, ("global", "local", "bidir"))
    if kind == "bidir" and cache is not None:
        raise ValueError("a bidir attention keeps no cache")
    scale = cfg.attn_scale or cfg.head_dim ** -0.5
    q, k, v = qkv_project(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    window = cfg.local_window if kind == "local" else 0
    out = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=kind != "bidir", window=window,
                              softcap=cfg.attn_softcap, scale=scale)
    y = _out_proj(out, p.wo)
    new_cache = None
    if cache is not None:
        new_cache = _prefill_cache(cache, k, v, positions, kind)
    return y, new_cache


# ------------------------------ KV cache ---------------------------------

def make_cache(cfg, batch, max_len, kind="global", dtype=torch.bfloat16,
               device="cuda"):
    """Cache entry for one attention layer. Local layers use a ring buffer."""
    _check_kind(kind)
    size = min(max_len, cfg.local_window) if kind == "local" else max_len
    shape = (batch, size, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((size,), -1, dtype=torch.int32, device=device),
    }


def _prefill_cache(cache, k, v, positions, kind):
    size = cache["k"].shape[1]
    if kind == "local" and k.shape[1] > size:
        # keep the last `size` positions (ring layout: slot = pos % size)
        k, v, positions = k[:, -size:], v[:, -size:], positions[-size:]
    slot = (positions % size if kind == "local" else positions).long()
    cache["k"][:, slot] = k.to(cache["k"].dtype)
    cache["v"][:, slot] = v.to(cache["v"].dtype)
    cache["pos"][slot] = positions.to(torch.int32)
    return cache


def decode_attention(cfg, p, x, index, cache, *, kind="global"):
    """One-token decode step.

    x: (B, 1, d); index: 0-d int tensor on x's device (the current position,
    uniform across the batch); cache: dict from make_cache. Returns
    (y (B,1,d), cache).
    """
    _check_kind(kind)
    b = x.shape[0]
    scale = cfg.attn_scale or cfg.head_dim ** -0.5
    pos = index.reshape(1)
    q, k, v = qkv_project(cfg, p, x)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)

    ck, cv = cache["k"], cache["v"]
    size = ck.shape[1]
    slot = (pos % size if kind == "local" else pos).long()
    ck.index_copy_(1, slot, k.to(ck.dtype))
    cv.index_copy_(1, slot, v.to(cv.dtype))
    cache["pos"].index_copy_(0, slot, pos.to(torch.int32))

    # The JAX decode masks by the cache's `pos` array; the kernel masks by a
    # valid length per row. They agree because a global cache is filled
    # contiguously from slot 0: after this write, slots 0..index hold
    # positions 0..index and the rest are empty, so length = index + 1. A
    # ring of size <= window holds only positions inside the window, the
    # last min(index + 1, size) of them in slots 0..min(index + 1, size) - 1,
    # and softmax does not care about their order. Past the wrap (index + 1
    # > size) every slot holds one of the last `size` positions, all inside
    # the window, so length = size.
    n_valid = pos + 1 if kind == "global" else torch.clamp(pos + 1, max=size)
    lengths = n_valid.to(torch.int32).expand(b).contiguous()
    # The kernel reads one dtype, so q is rounded to the cache's dtype (a
    # no-op when compute and cache dtypes agree, as on the serving path).
    out = ops.decode_attention(q[:, 0].to(ck.dtype).contiguous(), ck, cv,
                               lengths, scale=scale, softcap=cfg.attn_softcap)[:, None]
    return _out_proj(out, p.wo), cache


# --------------------------- cross-attention -----------------------------

def cross_kv(cfg, p, enc_out):
    """The fixed K/V (B,F,K,hd) of a cross-attention over the encoder's
    output (B,F,d), in its dtype: the projections and biases, no rope and no
    qk-norm, as the JAX package's ``_cross_kv``."""
    k, v = _proj(enc_out, p.wk), _proj(enc_out, p.wv)
    if p.bk is not None:
        dt = enc_out.dtype
        k, v = k + p.bk.to(dt), v + p.bv.to(dt)
    return k, v


def cross_attention(cfg, p, x, k, v, *, decode=False):
    """x (B,S,d) attends over fixed k, v (B,F,K,hd) with no mask and no
    rope, scaled by head_dim**-0.5, as the JAX package's
    ``_cross_attention``: the prefill through K1 (q of S positions, k and v
    of F), a one-token decode step (`decode`) through K2 with every row's
    length F (q rounded to k's dtype, as ``decode_attention`` does).
    Returns y (B,S,d)."""
    scale = cfg.head_dim ** -0.5
    q = _proj(x, p.wq)
    if p.bq is not None:
        q = q + p.bq.to(x.dtype)
    if decode:
        lengths = torch.full((x.shape[0],), k.shape[1], dtype=torch.int32, device=x.device)
        out = ops.decode_attention(q[:, 0].to(k.dtype).contiguous(), k, v, lengths,
                                   scale=scale)[:, None]
    else:
        out = ops.flash_attention(q.contiguous(), k, v, causal=False, scale=scale)
    return _out_proj(out, p.wo)
