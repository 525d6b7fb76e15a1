"""Mamba2 SSD (state-space duality) layer.

Mirrors ``repro.nn.ssd``. Prefill runs the chunked scan through
``ops.ssd_scan`` (K3 on the card, the plain chunked algorithm on the CPU);
decode is the one-step recurrence in plain PyTorch, as in the JAX package.

Shapes: x (B,S,H,P), dt (B,S,H), A (H,), B/C (B,S,G,N) with G groups.
State: (B,H,P,N) fp32.
"""

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.nn import init as inits
from repro_torch.nn.conv import CausalConv, causal_conv, causal_conv_step, conv_state_init
from repro_torch.nn.norms import Norm, apply_norm
from repro_torch.sharding.ctx import constrain, is_dtensor
from repro_torch.sharding.param import ParamMaker


class SSD(nn.Module):
    """in_proj (d, 2*din + 2*G*N + H), conv, A_log (H,), D (H,), dt_bias (H,),
    norm (din), out_proj (din, d): the JAX package's layout and names."""

    def __init__(self, cfg, *, gen=None, dtype=torch.float32, device="cpu"):
        super().__init__()
        d, din = cfg.d_model, cfg.ssm_dinner
        g, ns, nh = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
        kw = dict(gen=gen, dtype=dtype, device=device)

        mk = ParamMaker(self, gen, dtype, device)
        self.in_proj = mk("in_proj", (d, 2 * din + 2 * g * ns + nh), ("embed", "mlp"),
                          inits.fan_in())
        self.conv = CausalConv(din + 2 * g * ns, cfg.ssm_conv, **kw)
        self.A_log = mk("A_log", (nh,), ("heads",), inits.a_log_init)
        self.D = mk("D", (nh,), ("heads",), inits.ones)
        self.dt_bias = mk("dt_bias", (nh,), ("heads",), inits.dt_bias_init())
        self.norm = Norm(din, **kw, axis="mlp")
        self.out_proj = mk("out_proj", (din, d), ("mlp", "embed"), inits.fan_in())


def ssd_chunked(x, dt, a, bmat, cmat, chunk, h0=None):
    """Chunked SSD scan: ``repro.nn.ssd.ssd_chunked``'s signature, through
    ``ops.ssd_scan``. Returns (y (B,S,H,P), final_state (B,H,P,N)). On
    DTensors it runs on each rank's shards (``local_map``): x, dt, a, h0 and
    the outputs sharded over batch and heads, b and c over batch only and
    sliced to the groups of the rank's heads."""
    if not is_dtensor(x):
        return ops.ssd_scan(x, dt, a, bmat, cmat, chunk=chunk, h0=h0, return_state=True)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.nn.attention import kv_for_heads
    from repro_torch.sharding.comm import mesh_index, shard_dims

    mesh = x.device_mesh
    xp = tuple(x.placements)
    heads = shard_dims(xp, 2)
    batch = shard_dims(xp, 0)

    def pl(bdim, hdim):
        return tuple(Shard(bdim) if i in batch else Shard(hdim) if i in heads else Replicate()
                     for i in range(mesh.ndim))
    a_pl = tuple(Shard(0) if i in heads else Replicate() for i in range(mesh.ndim))
    bc_pl = tuple(Shard(0) if i in batch else Replicate() for i in range(mesh.ndim))
    st_pl = pl(0, 1)
    args = [x, dt, a, bmat, cmat, h0]
    want = [xp, pl(0, 2), a_pl, bc_pl, bc_pl, st_pl]
    args = [t if t is None or not is_dtensor(t) or tuple(t.placements) == w
            else t.redistribute(mesh, w) for t, w in zip(args, want)]
    group = x.shape[2] // bmat.shape[2]

    def body(xl, dtl, al, bl, cl, hl):
        n = xl.shape[2]
        bl, cl = kv_for_heads(bl, cl, mesh_index(mesh, heads) * n, n, group)
        return ops.ssd_scan(xl.contiguous(), dtl, al, bl.contiguous(), cl.contiguous(),
                            chunk=chunk, h0=hl, return_state=True)
    return local_map(body, out_placements=(xp, st_pl),
                     in_placements=tuple(w if t is not None else None
                                         for t, w in zip(args, want)),
                     device_mesh=mesh)(*args)


def ssd_layer(cfg, p, u, state=None, conv_state=None, decode=False):
    """Full Mamba2 layer. u (B,S,d). Returns (out, (ssm_state, conv_state))."""
    dt_ = u.dtype
    din, g, ns, nh = cfg.ssm_dinner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    zxbcdt = u @ p.in_proj.to(dt_)
    z, xbc, dtraw = zxbcdt[..., :din], zxbcdt[..., din:2 * din + 2 * g * ns], zxbcdt[..., -nh:]
    if decode:
        xbc, conv_state = causal_conv_step(p.conv, xbc, conv_state)
    else:
        if conv_state is not None:
            # keep the last W-1 *pre-conv* inputs for a later decode handoff
            tail = xbc[:, -conv_state.shape[1]:].to(conv_state.dtype)
            conv_state = torch.cat([conv_state[:, tail.shape[1]:], tail], dim=1)
        xbc = causal_conv(p.conv, xbc)
    xbc = F.silu(xbc)
    bsz, s = u.shape[0], u.shape[1]
    pd = cfg.ssm_headdim
    x = constrain(xbc[..., :din].reshape(bsz, s, nh, pd), "act_batch", "act_seq", "act_heads",
                  None)
    bmat = xbc[..., din:din + g * ns].reshape(bsz, s, g, ns)
    cmat = xbc[..., din + g * ns:].reshape(bsz, s, g, ns)
    dt = F.softplus(dtraw.float() + p.dt_bias.float())
    a = -torch.exp(p.A_log.float())

    if decode:
        # one-step recurrence: state (B,H,P,N)
        rep = nh // g
        da = torch.exp(dt[:, 0] * a)                                  # (B,H)
        bx = torch.einsum("bhp,bhn,bh->bhpn", x[:, 0].float(),
                          bmat[:, 0].float().repeat_interleave(rep, dim=1), dt[:, 0])
        state = da[..., None, None] * state + bx
        y = torch.einsum("bhn,bhpn->bhp", cmat[:, 0].float().repeat_interleave(rep, dim=1),
                         state)[:, None]
        y = y.to(dt_)
    else:
        # packed copies of the views: the kernel reads (B,S,H,P) and (B,S,G,N)
        y, state = ssd_chunked(x.contiguous(), dt, a, bmat.contiguous(), cmat.contiguous(),
                               cfg.ssm_chunk, h0=state)
    y = y + x * p.D.to(dt_)[None, None, :, None]
    y = y.reshape(bsz, s, din)
    y = apply_norm(p.norm, y * F.silu(z), cfg.norm_eps)
    return y @ p.out_proj.to(dt_), (state, conv_state)


def ssd_state_init(cfg, batch, dtype, device):
    """(ssm_state fp32 (B,H,P,N), conv_state (B,W-1,C) in `dtype`)."""
    h, pd, n, g = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_ngroups
    return (torch.zeros((batch, h, pd, n), dtype=torch.float32, device=device),
            conv_state_init(batch, cfg.ssm_dinner + 2 * g * n, cfg.ssm_conv, dtype, device))
