"""RG-LRU recurrent block (RecurrentGemma / Griffin).

Mirrors ``repro.nn.rglru``. Recurrence, per channel:
    r_t = sigmoid(W_a x_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)            (input gate)
    log a_t = -c * softplus(Lambda) * r_t   (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the recurrence through ``ops.rglru_scan`` (K4 on the card, its
plain loop on the CPU) where the JAX package takes an associative scan;
decode is the one-step recurrence in plain PyTorch, as in the JAX package.
The full block is: x,y = proj(u); y = gelu(y); x = conv1d(x); h = RGLRU(x);
out = proj_out(h * y).
"""

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.nn import init as inits
from repro_torch.nn.conv import CausalConv, causal_conv, causal_conv_step, conv_state_init
from repro_torch.sharding.ctx import constrain, is_dtensor
from repro_torch.sharding.param import ParamMaker

C_FACTOR = 8.0
CONV_WIDTH = 4


class RGLRU(nn.Module):
    """wx, wy (d, W), conv, gate_a, gate_x (W, W), ba, bx, lam (W,), wo (W, d):
    the JAX package's layout, names and initialisers."""

    def __init__(self, cfg, *, gen=None, dtype=torch.float32, device="cpu"):
        super().__init__()
        d, w = cfg.d_model, cfg.lru_width

        mk = ParamMaker(self, gen, dtype, device)
        self.wx = mk("wx", (d, w), ("embed", "mlp"), inits.fan_in())
        self.wy = mk("wy", (d, w), ("embed", "mlp"), inits.fan_in())
        self.conv = CausalConv(w, CONV_WIDTH, gen=gen, dtype=dtype, device=device)
        self.gate_a = mk("gate_a", (w, w), ("mlp", None), inits.fan_in())
        self.ba = mk("ba", (w,), ("mlp",), inits.zeros)
        self.gate_x = mk("gate_x", (w, w), ("mlp", None), inits.fan_in())
        self.bx = mk("bx", (w,), ("mlp",), inits.zeros)
        self.lam = mk("lam", (w,), ("mlp",), inits.lru_a_init())
        self.wo = mk("wo", (w, d), ("mlp", "embed"), inits.fan_in())


def _gates(p, x):
    """(a, gated x), both fp32 (B,S,W). The products are fp32 matmuls, which
    stay full fp32 on the card while TF32 is off (PyTorch's default)."""
    xf = x.float()
    r = torch.sigmoid(xf @ p.gate_a.float() + p.ba.float())
    i = torch.sigmoid(xf @ p.gate_x.float() + p.bx.float())
    log_a = -C_FACTOR * F.softplus(p.lam.float()) * r             # (B,S,W) <= 0
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * xf)
    return a, gated_x


def rglru(p, x, h0=None):
    """x (B,S,W) -> (h (B,S,W) in x's dtype, h_last (B,W) fp32), through
    ``ops.rglru_scan``; h0 (B,W) or None (zeros)."""
    a, b = _gates(p, x)
    h0 = None if h0 is None else h0.float().contiguous()
    if not is_dtensor(a):
        return ops.rglru_scan(a, b, h0=h0, out_dtype=x.dtype)
    # on DTensors: each rank scans its own lanes (the recurrence is per lane)
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map
    mesh, ap = a.device_mesh, tuple(a.placements)
    if any(isinstance(q, Shard) and q.dim == 1 for q in ap):
        raise NotImplementedError("an RG-LRU scan sharded over its sequence")
    hp = tuple(Shard(1) if isinstance(q, Shard) and q.dim == 2 else q for q in ap)
    b = b if tuple(b.placements) == ap else b.redistribute(mesh, ap)
    if h0 is not None and is_dtensor(h0) and tuple(h0.placements) != hp:
        h0 = h0.redistribute(mesh, hp)
    return local_map(lambda a, b, h: ops.rglru_scan(a.contiguous(), b.contiguous(), h0=h,
                                                    out_dtype=x.dtype),
                     out_placements=(ap, hp),
                     in_placements=(ap, ap, None if h0 is None else hp),
                     device_mesh=mesh)(a, b, h0)


def rglru_block(cfg, p, u, h0=None, conv_state=None, decode=False):
    """Full recurrent block. Returns (out, (h_last, conv_state))."""
    dt = u.dtype
    x = u @ p.wx.to(dt)
    y = F.gelu(u @ p.wy.to(dt), approximate="tanh")   # jax.nn.gelu's default
    x = constrain(x, "act_batch", "act_seq", "act_mlp")
    if decode:
        x, conv_state = causal_conv_step(p.conv, x, conv_state)
        a, b = _gates(p, x)
        h = a * h0[:, None, :].float() + b
        out_h, h_last = h.to(dt), h[:, 0]
    else:
        if conv_state is not None:
            # keep the last W-1 *pre-conv* inputs for a later decode handoff
            tail = x[:, -conv_state.shape[1]:].to(conv_state.dtype)
            conv_state = torch.cat([conv_state[:, tail.shape[1]:], tail], dim=1)
        x = causal_conv(p.conv, x)
        out_h, h_last = rglru(p, x, h0)
    out = (out_h * y) @ p.wo.to(dt)
    return out, (h_last, conv_state)


def rglru_state_init(cfg, batch, dtype, device):
    """(h fp32 (B,W), conv_state (B,3,W) in `dtype`)."""
    return (torch.zeros((batch, cfg.lru_width), dtype=torch.float32, device=device),
            conv_state_init(batch, cfg.lru_width, CONV_WIDTH, dtype, device))
