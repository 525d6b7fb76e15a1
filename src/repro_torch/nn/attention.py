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

Padded heads (tp > 1): wq, bq and wo hold ``cfg.padded_heads`` query heads,
a multiple of lcm(tp, kv heads), as the reference's. The kernels read the
kv heads unexpanded with a group of padded_heads // kv_heads query heads,
which is the reference's ``jnp.repeat(k, hp // k_heads)``; the padded
heads' outputs are multiplied by zero (``head_mask``) before ``wo``, so
they add nothing to the output and their rows of wo get no gradient. The
mask stays outside the kernels.

Under a sharding context (``sharding.ctx``) q, k, v, the output and the
cache may be DTensors: activations are constrained where the reference
constrains them, and the kernels run on each rank's local shards through
``local_map`` (``_heads_call``), never on a DTensor. A rank holding a
slice of the (padded) query heads reads the kv heads those heads group
on. A decode cache whose sequence is sharded (``act_kv_seq``, the
reference's decode layout: flash-decoding-style distributed attention) is
written at the rank that holds the slot, and attended on each rank by K2
over its chunk, with the lengths clamped to it, returning its fp32
output and each row's log-sum-exp; the partials are combined by
all-reduces over the sharding axes (``merge_partials``: the max of the
log-sum-exps, then the weighted sums), and the result rounded once to
K2's output dtype. On one rank the weight is exp(0) and the sum divides
by 1, so the result is K2's output without the log-sum-exp, bit for
bit. The
encoder-decoder's cross-attention decode takes the same path, so its
``xk`` and ``xv``, sharded over their frames, stay where they are.
"""

from typing import Optional

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.nn import init as inits
from repro_torch.nn.norms import Norm, apply_norm
from repro_torch.nn.rope import apply_rope
from repro_torch.sharding.comm import max_over, mesh_index, shard_dims, sum_over
from repro_torch.sharding.ctx import constrain, gather_dim, is_dtensor
from repro_torch.sharding.param import ParamMaker


class Attention(nn.Module):
    """wq (d,H,hd), wk/wv (d,K,hd), wo (H,hd,d), the biases bq (H,hd) and
    bk/bv (K,hd) with `cfg.qkv_bias`, qk-norm scales: the JAX package's
    layout, with `cfg.padded_heads` query heads."""

    def __init__(self, cfg, *, gen=None, dtype=torch.float32, device="cpu"):
        super().__init__()
        d, hp, k, hd = cfg.d_model, cfg.padded_heads, cfg.num_kv_heads, cfg.head_dim
        mk = ParamMaker(self, gen, dtype, device)
        self.wq = mk("wq", (d, hp, hd), ("embed", "heads", "head_dim"), inits.fan_in())
        self.wk = mk("wk", (d, k, hd), ("embed", "kv_heads", "head_dim"), inits.fan_in())
        self.wv = mk("wv", (d, k, hd), ("embed", "kv_heads", "head_dim"), inits.fan_in())
        self.wo = mk("wo", (hp, hd, d), ("heads", "head_dim", "embed"),
                     inits.fan_in(in_axes=(0, 1)))
        self.bq = self.bk = self.bv = None
        if cfg.qkv_bias:
            self.bq = mk("bq", (hp, hd), ("heads", "head_dim"), inits.zeros)
            self.bk = mk("bk", (k, hd), ("kv_heads", "head_dim"), inits.zeros)
            self.bv = mk("bv", (k, hd), ("kv_heads", "head_dim"), inits.zeros)
        kw = dict(kind=cfg.norm, gen=gen, dtype=dtype, device=device, axis="head_dim")
        self.q_norm = Norm(hd, **kw) if cfg.qk_norm else None
        self.k_norm = Norm(hd, **kw) if cfg.qk_norm else None


def _check_kind(kind, kinds=("global", "local")):
    if kind not in kinds:
        raise NotImplementedError(f"attention kind {kind!r} is not ported yet")


def head_mask(cfg, dtype, device):
    """(Hp,) ones on the real heads and zeros on the padded ones, or None
    when no head is padded (the reference's ``_head_mask``)."""
    hp = cfg.padded_heads
    if hp == cfg.num_heads:
        return None
    return (torch.arange(hp, device=device) < cfg.num_heads).to(dtype)


def mask_heads(cfg, out):
    """out (B,S,Hp,hd) with the padded heads' outputs zeroed."""
    hm = head_mask(cfg, out.dtype, out.device)
    return out if hm is None else out * hm[None, None, :, None]


# ------------------------------ sharded calls -----------------------------

def kv_for_heads(k, v, h0, hl, group):
    """The kv heads that query heads h0 .. h0 + hl - 1 read, query head h
    reading kv head h // group: a contiguous slice where the local heads
    cover whole groups or lie in one, else one kv head a query head."""
    if hl % group == 0 and h0 % group == 0:
        return k[:, :, h0 // group:(h0 + hl) // group], v[:, :, h0 // group:(h0 + hl) // group]
    if group % hl == 0 and h0 % hl == 0:
        j = h0 // group
        return k[:, :, j:j + 1], v[:, :, j:j + 1]
    idx = torch.div(torch.arange(h0, h0 + hl, device=k.device), group, rounding_mode="floor")
    return k.index_select(2, idx), v.index_select(2, idx)


def _kv_placements(q_placements):
    """k and v's placements for a call on q's: q's batch sharding, every
    other mesh dim replicated (the kv heads are sliced on each rank)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for pl in q_placements:
        if isinstance(pl, Shard) and pl.dim not in (0, 2):
            raise NotImplementedError(f"attention with q sharded on dim {pl.dim}")
        if not isinstance(pl, (Shard, Replicate)):
            raise NotImplementedError(f"attention on q placed {pl}")
        out.append(pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate())
    return tuple(out)


def _heads_call(fn, q, k, v):
    """fn(q (B,S,H,D), k, v (B,S_kv,K,D)) -> (B,S,H,D). On DTensors, on
    each rank's shards (``local_map``): q sharded over batch and heads, k
    and v over batch only, and fn given the kv heads its query heads read
    (``kv_for_heads``); with K == H, k and v sharded as q. The kernels never
    see a DTensor."""
    if not is_dtensor(q):
        return fn(q, k, v)
    from torch.distributed.tensor.experimental import local_map

    mesh, qp = q.device_mesh, tuple(q.placements)
    group = q.shape[2] // k.shape[2]
    # one kv head a query head (MHA): k and v sharded on the heads as q is
    kvp = qp if group == 1 else _kv_placements(qp)
    k, v = (t if tuple(t.placements) == kvp else t.redistribute(mesh, kvp) for t in (k, v))
    head_dims = shard_dims(qp, 2)

    def body(ql, kl, vl):
        hl = ql.shape[2]
        if group > 1:
            kl, vl = kv_for_heads(kl, vl, mesh_index(mesh, head_dims) * hl, hl, group)
        return fn(ql, kl, vl)
    return local_map(body, out_placements=(qp,), in_placements=(qp, kvp, kvp),
                     device_mesh=mesh)(q, k, v)


def _write_rows(t, dim, slots, rows):
    """t[..., slots, ...] = rows along `dim` (slots (n,) int64 on t's device,
    rows with n along `dim`), in place. A DTensor cache sharded along `dim`
    is written by the rank that holds each slot: slots outside its chunk
    are dropped by a scatter into one spare row, with no data-dependent
    shape."""
    if not is_dtensor(t):
        t.index_copy_(dim, slots, rows.to(t.dtype))
        return t
    from torch.distributed.tensor import Replicate
    mesh, tp = t.device_mesh, tuple(t.placements)
    want = tuple(Replicate() if i in shard_dims(tp, dim) else pl for i, pl in enumerate(tp))
    if is_dtensor(rows):
        rows = rows if tuple(rows.placements) == want else rows.redistribute(mesh, want)
        rows = rows.to_local()
    rows = rows.to(t.dtype)
    local = t.to_local()
    seq_dims = shard_dims(tp, dim)
    if not seq_dims:
        local.index_copy_(dim, slots, rows)
        return t
    n_local = local.shape[dim]
    s0 = mesh_index(mesh, seq_dims) * n_local
    rel = slots - s0
    ok = (rel >= 0) & (rel < n_local)
    src = torch.full((n_local + 1,), -1, dtype=torch.long, device=local.device)
    src.scatter_(0, torch.where(ok, rel, n_local), torch.arange(slots.numel(), device=local.device))
    src = src[:n_local]
    has = (src >= 0).reshape([-1 if i == dim else 1 for i in range(local.dim())])
    picked = rows.index_select(dim, src.clamp(min=0))
    local.copy_(torch.where(has, picked, local))
    return t


def _proj(x, w):
    """x (B,S,d) @ w (d,N,hd) -> (B,S,N,hd), contiguous. A DTensor w is
    first gathered over its d_model (FSDP), so that the product keeps x's
    batch sharding and N's."""
    w = gather_dim(w, 0)
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
    q = constrain(q, "act_batch", "act_seq", "act_heads", None)
    window = cfg.local_window if kind == "local" else 0
    out = _heads_call(lambda q, k, v: ops.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=kind != "bidir",
        window=window, softcap=cfg.attn_softcap, scale=scale), q, k, v)
    out = constrain(mask_heads(cfg, out), "act_batch", "act_seq", "act_heads", None)
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
    _write_rows(cache["k"], 1, slot, k)
    _write_rows(cache["v"], 1, slot, v)
    _write_rows(cache["pos"], 0, slot, positions.to(torch.int32))
    return cache


def decode_attention(cfg, p, x, index, cache, *, kind="global"):
    """One-token decode step.

    x: (B, 1, d); index: 0-d int tensor on x's device (the current position,
    uniform across the batch); cache: dict from make_cache. Returns
    (y (B,1,d), cache).
    """
    _check_kind(kind)
    scale = cfg.attn_scale or cfg.head_dim ** -0.5
    pos = index.reshape(1)
    q, k, v = qkv_project(cfg, p, x)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)

    ck, cv = cache["k"], cache["v"]
    size = ck.shape[1]
    slot = (pos % size if kind == "local" else pos).long()
    _write_rows(ck, 1, slot, k)
    _write_rows(cv, 1, slot, v)
    _write_rows(cache["pos"], 0, slot, pos.to(torch.int32))

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
    # DP attention, as the reference's: q batch-sharded only for the
    # cache-wide contraction, the output back on the heads for wo
    q = constrain(q, "act_batch", None, None, None)
    out = _decode_call(q[:, 0], ck, cv, n_valid, scale=scale, softcap=cfg.attn_softcap)
    out = constrain(mask_heads(cfg, out[:, None]), "act_batch", None, "act_heads", None)
    return _out_proj(out, p.wo), cache


def _decode_kernel(q, k, v, n_valid, scale, softcap, return_lse=False):
    """K2 on plain tensors, every row's length `n_valid` (a 1-element
    tensor). The kernel reads one dtype, so q is rounded to the cache's (a
    no-op when compute and cache dtypes agree, as on the serving path)."""
    lengths = n_valid.to(torch.int32).expand(q.shape[0]).contiguous()
    return ops.decode_attention(q.to(k.dtype).contiguous(), k, v, lengths, scale=scale,
                                softcap=softcap, return_lse=return_lse)


def merge_partials(out, lse, max_all, sum_all):
    """The softmax over a cache split into chunks, from each chunk's
    partial: `out` (..., D) fp32, its output over its own valid slots, and
    `lse` (...) fp32, their log-sum-exp. `max_all` and `sum_all` reduce
    over the chunks: all-reduces over the ranks in ``_decode_call``, a
    reduction over a stacked dim where one process holds every chunk. A
    chunk with no valid slot has the log-sum-exp -1e30 and weighs exactly
    0. -> fp32, in the shape `sum_all` leaves."""
    w = torch.exp(lse - max_all(lse))
    return sum_all(out * w[..., None]) / sum_all(w)[..., None]


def _decode_call(q, ck, cv, n_valid, *, scale, softcap):
    """q (B,Hp,D) against the cache: K2 on plain tensors or on each rank's
    shards; with the cache's sequence sharded, K2 over each rank's chunk
    with its log-sum-exp, the partials combined by all-reduces over the
    sharding axes (``merge_partials``) and rounded once. -> (B,Hp,D) in
    the cache's dtype, K2's (q is rounded to it first)."""
    if not is_dtensor(ck):
        return _decode_kernel(q, ck, cv, n_valid, scale, softcap)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh, cp = ck.device_mesh, tuple(ck.placements)
    seq_dims = shard_dims(cp, 1)
    # q and the output: the cache's batch sharding, replicated elsewhere
    bp = tuple(Replicate() if i in seq_dims else pl for i, pl in enumerate(cp))
    q = q if tuple(q.placements) == bp else q.redistribute(mesh, bp)

    def body(ql, kl, vl, nv):
        if not seq_dims:
            return _decode_kernel(ql, kl, vl, nv, scale, softcap)
        s_local = kl.shape[1]   # the valid slots of this rank's chunk, 0 past them
        nv = torch.clamp(nv - mesh_index(mesh, seq_dims) * s_local, 0, s_local)
        out, lse = _decode_kernel(ql, kl, vl, nv, scale, softcap, return_lse=True)
        merged = merge_partials(out, lse, lambda t: max_over(t, mesh, seq_dims),
                                lambda t: sum_over(t, mesh, seq_dims))
        return merged.to(kl.dtype)   # K2's output dtype, as without the sharding
    return local_map(body, out_placements=(bp,), in_placements=(bp, cp, cp, None),
                     device_mesh=mesh)(q, ck, cv, n_valid)


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
    q = constrain(q, "act_batch", "act_seq", "act_heads", None)
    if decode:
        # DP attention as in `decode_attention`: every frame valid, the
        # partials combined over the ranks when the frames are sharded
        q = constrain(q, "act_batch", None, None, None)
        n_valid = torch.full((1,), k.shape[1], dtype=torch.int32, device=q.device)
        out = _decode_call(q[:, 0], k, v, n_valid, scale=scale, softcap=None)[:, None]
        out = constrain(out, "act_batch", None, "act_heads", None)
    else:
        out = _heads_call(lambda q, k, v: ops.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=False, scale=scale), q, k, v)
    return _out_proj(mask_heads(cfg, out), p.wo)
