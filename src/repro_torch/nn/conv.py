"""Causal depthwise temporal conv1d (Mamba blocks), with a decode-time
rolling buffer. Mirrors ``repro.nn.conv`` and keeps its layout: `w` is
(W, C), activations (B, S, C).

The conv is a sum of W shifted slices, as in the JAX package, rather than
``F.conv1d``: on the card an fp32 ``conv1d`` goes through cuDNN, which
takes TF32 by default, and the slices keep the arithmetic of the
reference on every device.
"""

import torch
from torch import nn

from repro_torch.nn import init as inits
from repro_torch.sharding.param import ParamMaker


class CausalConv(nn.Module):
    """`w` (W, C) and `b` (C,)."""

    def __init__(self, channels, width, *, gen=None, dtype=torch.float32, device="cpu"):
        super().__init__()
        mk = ParamMaker(self, gen, dtype, device)
        self.w = mk("w", (width, channels), ("conv", "mlp"), inits.fan_in())
        self.b = mk("b", (channels,), ("mlp",), inits.zeros)


def causal_conv(p, x):
    """x (B,S,C) -> (B,S,C); depthwise causal conv of width W."""
    w = p.w.to(x.dtype)                              # (W, C)
    width, s = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, width - 1, 0))
    out = sum(xp[:, i:i + s] * w[i] for i in range(width))
    return out + p.b.to(x.dtype)


def conv_state_init(batch, channels, width, dtype, device):
    return torch.zeros((batch, width - 1, channels), dtype=dtype, device=device)


def causal_conv_step(p, x_t, state):
    """x_t (B,1,C), state (B,W-1,C) -> (y_t (B,1,C), new_state)."""
    w = p.w.to(x_t.dtype)
    buf = torch.cat([state.to(x_t.dtype), x_t], dim=1)    # (B, W, C)
    y = torch.einsum("bwc,wc->bc", buf, w)[:, None] + p.b.to(x_t.dtype)
    return y, buf[:, 1:].to(state.dtype)
