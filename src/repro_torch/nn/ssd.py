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


class SSD(nn.Module):
    """in_proj (d, 2*din + 2*G*N + H), conv, A_log (H,), D (H,), dt_bias (H,),
    norm (din), out_proj (din, d): the JAX package's layout and names."""

    def __init__(self, cfg, *, gen=None, dtype=torch.float32, device="cpu"):
        super().__init__()
        d, din = cfg.d_model, cfg.ssm_dinner
        g, ns, nh = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
        kw = dict(gen=gen, dtype=dtype, device=device)

        def mk(init, shape):
            return nn.Parameter(init(gen, shape, dtype, device), requires_grad=False)
        self.in_proj = mk(inits.fan_in(), (d, 2 * din + 2 * g * ns + nh))
        self.conv = CausalConv(din + 2 * g * ns, cfg.ssm_conv, **kw)
        self.A_log = mk(inits.a_log_init, (nh,))
        self.D = mk(inits.ones, (nh,))
        self.dt_bias = mk(inits.dt_bias_init(), (nh,))
        self.norm = Norm(din, **kw)
        self.out_proj = mk(inits.fan_in(), (din, d))


def ssd_chunked(x, dt, a, bmat, cmat, chunk, h0=None):
    """Chunked SSD scan: ``repro.nn.ssd.ssd_chunked``'s signature, through
    ``ops.ssd_scan``. Returns (y (B,S,H,P), final_state (B,H,P,N))."""
    return ops.ssd_scan(x, dt, a, bmat, cmat, chunk=chunk, h0=h0, return_state=True)


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
    x = xbc[..., :din].reshape(bsz, s, nh, pd)
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
