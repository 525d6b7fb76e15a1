"""Multi-head Latent Attention (DeepSeek-V2/V3).

Mirrors ``repro.nn.mla``. Prefill uses the naive form, per-head K and V
made from the compressed latent; one-token decode uses the absorbed form,
the KV up-projections folded into the query and output sides, so that the
cache holds only kv_lora_rank + qk_rope_head_dim values a token.

The naive form's attention goes through K1 (``ops.flash_attention``). K1
takes one head_dim for q, k and v, from ``HEAD_DIMS``; MLA's q and k have
qk_nope + qk_rope (192 at DeepSeek-V3's widths) and v has v_head_dim
(128). So q = [q_nope; q_rope], k = [k_nope; k_rope broadcast over the
heads] and v are zero-padded to the smallest head_dim of K1 that holds
both (256), with the scale 1/sqrt(qk_nope + qk_rope) passed explicitly,
and the output is cut back to v_head_dim. The zero columns add nothing
to any logit or output, so this is the reference's ``attend_ref``
function; it runs the same way on the CPU, through K1's plain version.

The absorbed decode is plain PyTorch (matmuls and a masked fp32 softmax),
as the reference writes it with einsums: no TPU kernel computes it, and
K2 takes no 128 query heads over one 576-wide key. Its cache is written
at the batch-wide index, and it attends where (pos >= 0) & (pos <= index).
"""

import math

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.nn import init as inits
from repro_torch.nn.norms import Norm, apply_norm
from repro_torch.nn.rope import apply_rope
from repro_torch.nn.attention import _heads_call, _write_rows, merge_partials
from repro_torch.sharding.comm import max_over, mesh_index, shard_dims, sum_over
from repro_torch.sharding.ctx import constrain, is_dtensor
from repro_torch.sharding.param import ParamMaker

NEG_INF = -2.0e38


class MLA(nn.Module):
    """wdq (d, qr), q_norm (qr), wuq (qr, H, dn+dr), wdkv (d, kvr+dr),
    kv_norm (kvr), wuk (kvr, H, dn), wuv (kvr, H, dv), wo (H, dv, d): the
    JAX package's layout and names."""

    def __init__(self, cfg, *, gen=None, dtype=torch.float32, device="cpu"):
        super().__init__()
        d, h = cfg.d_model, cfg.num_heads
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim

        mk = ParamMaker(self, gen, dtype, device)
        kw = dict(kind=cfg.norm, gen=gen, dtype=dtype, device=device, axis="qk_rank")
        self.wdq = mk("wdq", (d, qr), ("embed", "qk_rank"), inits.fan_in())
        self.q_norm = Norm(qr, **kw)
        self.wuq = mk("wuq", (qr, h, dn + dr), ("qk_rank", "heads", "head_dim"), inits.fan_in())
        self.wdkv = mk("wdkv", (d, kvr + dr), ("embed", "qk_rank"), inits.fan_in())
        self.kv_norm = Norm(kvr, **kw)
        self.wuk = mk("wuk", (kvr, h, dn), ("qk_rank", "heads", "head_dim"), inits.fan_in())
        self.wuv = mk("wuv", (kvr, h, dv), ("qk_rank", "heads", "head_dim"), inits.fan_in())
        self.wo = mk("wo", (h, dv, d), ("heads", "head_dim", "embed"),
                     inits.fan_in(in_axes=(0, 1)))


def padded_head_dim(cfg):
    """K1's head_dim for MLA's prefill: the smallest of ``HEAD_DIMS`` that
    holds qk_nope + qk_rope and v_head_dim."""
    need = max(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim)
    fits = [d for d in HEAD_DIMS if d >= need]
    if not fits:
        raise NotImplementedError(f"MLA head dims {need} exceed K1's largest, {HEAD_DIMS[-1]}")
    return fits[0]


def _up(x, w):
    """x (B,S,r) @ w (r,H,k) -> (B,S,H,k)."""
    b, s, _ = x.shape
    return (x @ w.to(x.dtype).reshape(w.shape[0], -1)).view(b, s, w.shape[1], w.shape[2])


def _project_q(cfg, p, x, positions):
    dn = cfg.qk_nope_head_dim
    cq = apply_norm(p.q_norm, x @ p.wdq.to(x.dtype), cfg.norm_eps)
    q = _up(cq, p.wuq)
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _project_kv_latent(cfg, p, x, positions):
    kvr = cfg.kv_lora_rank
    ckv = x @ p.wdkv.to(x.dtype)                                    # (B,S,kvr+dr)
    c_kv = apply_norm(p.kv_norm, ckv[..., :kvr], cfg.norm_eps)
    k_rope = apply_rope(ckv[..., kvr:], positions, cfg.rope_theta)  # one shared head
    return c_kv, k_rope


def _pad(x, d):
    return torch.nn.functional.pad(x, (0, d - x.shape[-1]))


def mla_attention(cfg, p, x, positions, *, cache=None):
    """Full-sequence MLA (naive form) through K1. Returns (y, the cache
    entry written in place, or None)."""
    b, s, _ = x.shape
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _project_q(cfg, p, x, positions)
    c_kv, k_rope = _project_kv_latent(cfg, p, x, positions)
    k_nope = _up(c_kv, p.wuk)
    v = _up(c_kv, p.wuv)
    dp = padded_head_dim(cfg)
    q = _pad(torch.cat([q_nope, q_rope], dim=-1), dp)
    q = constrain(q, "act_batch", "act_seq", "act_heads", None)
    k = _pad(torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)], dim=-1), dp)
    out = _heads_call(lambda q, k, v: ops.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
        scale=1.0 / math.sqrt(dn + dr)), q, k, _pad(v, dp))[..., :dv]
    out = constrain(out, "act_batch", "act_seq", "act_heads", None)
    y = out.reshape(b, s, h * dv) @ p.wo.to(x.dtype).reshape(h * dv, -1)
    if cache is not None:
        slot = positions.long()
        _write_rows(cache["c_kv"], 1, slot, c_kv)
        _write_rows(cache["k_rope"], 1, slot, k_rope)
        _write_rows(cache["pos"], 0, slot, positions.to(torch.int32))
    return y, cache


def make_mla_cache(cfg, batch, max_len, dtype=torch.bfloat16, device="cuda"):
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim), dtype=dtype,
                              device=device),
        "pos": torch.full((max_len,), -1, dtype=torch.int32, device=device),
    }


def mla_decode(cfg, p, x, index, cache):
    """One-token decode with the absorbed form over the compressed cache.
    x (B,1,d); index a 0-d int tensor, the position written for the whole
    batch. Returns (y (B,1,d), cache), the cache written in place."""
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    scale = 1.0 / math.sqrt(dn + dr)
    pos = index.reshape(1)
    dt = x.dtype

    q_nope, q_rope = _project_q(cfg, p, x, pos)        # (B,1,H,dn), (B,1,H,dr)
    c_kv_t, k_rope_t = _project_kv_latent(cfg, p, x, pos)
    slot = pos.long()
    ck, cr, cpos = cache["c_kv"], cache["k_rope"], cache["pos"]
    _write_rows(ck, 1, slot, c_kv_t)
    _write_rows(cr, 1, slot, k_rope_t)
    _write_rows(cpos, 0, slot, pos.to(torch.int32))

    # absorb wuk into q: q_eff (B,H,kvr) = q_nope . wuk over dn
    q_eff = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], p.wuk.to(dt))
    if is_dtensor(ck):
        ctx = _absorbed_sharded(q_eff, q_rope[:, 0], ck, cr, cpos, pos, scale)
        out = torch.einsum("bhr,rhd->bhd", ctx, p.wuv.to(dt))
        out = constrain(out, "act_batch", "act_heads", None)
        y = out.reshape(out.shape[0], -1) @ p.wo.to(dt).reshape(-1, p.wo.shape[-1])
        return y[:, None], cache
    ckd = ck.to(dt)
    s_lat = torch.bmm(q_eff, ckd.transpose(1, 2))                  # (B,H,S)
    s_rope = torch.bmm(q_rope[:, 0], cr.to(dt).transpose(1, 2))
    scores = (s_lat + s_rope).float() * scale
    valid = (cpos >= 0) & (cpos <= pos)
    scores = torch.where(valid[None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(dt)
    ctx = torch.bmm(w, ckd)                                         # (B,H,kvr)
    # absorb wuv on the output side
    out = torch.einsum("bhr,rhd->bhd", ctx, p.wuv.to(dt))           # (B,H,dv)
    y = out.reshape(out.shape[0], -1) @ p.wo.to(dt).reshape(-1, p.wo.shape[-1])
    return y[:, None], cache


def _absorbed_sharded(q_eff, q_rope, ck, cr, cpos, pos, scale):
    """The absorbed decode's context (B,H,kvr) over a DTensor cache, as
    DP attention: q batch-sharded only, each rank's partial softmax over
    its chunk of the cache's sequence, combined by all-reduces over the
    sequence's mesh dims (``local_map``, fp32 inside). Plain arithmetic:
    no kernel computes the absorbed form."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh, cp = ck.device_mesh, tuple(ck.placements)
    seq_dims = shard_dims(cp, 1)
    bp = tuple(Replicate() if i in seq_dims else pl for i, pl in enumerate(cp))
    q_eff, q_rope = (t if tuple(t.placements) == bp else t.redistribute(mesh, bp)
                     for t in (q_eff, q_rope))
    rep = (Replicate(),) * mesh.ndim
    cpos = cpos if tuple(cpos.placements) == rep else cpos.redistribute(mesh, rep)
    dt = q_eff.dtype

    def body(qe, qr, ckl, crl, cposl, p):
        s_local = ckl.shape[1]
        cposl = cposl.narrow(0, mesh_index(mesh, seq_dims) * s_local, s_local)
        scores = (torch.bmm(qe, ckl.to(dt).transpose(1, 2))
                  + torch.bmm(qr, crl.to(dt).transpose(1, 2))).float() * scale
        valid = (cposl >= 0) & (cposl <= p)
        scores = torch.where(valid[None, None, :], scores, NEG_INF)
        lse = torch.logsumexp(scores, dim=-1)
        part = torch.bmm(torch.exp(scores - lse[..., None]), ckl.float())
        ctx = merge_partials(part, lse, lambda t: max_over(t, mesh, seq_dims),
                             lambda t: sum_over(t, mesh, seq_dims))
        return ctx.to(dt)
    return local_map(body, out_placements=(bp,), in_placements=(bp, bp, cp, cp, rep, None),
                     device_mesh=mesh)(q_eff, q_rope, ck, cr, cpos, pos)
