"""LSTM cell (for the paper's R2D2 conv-LSTM agent).

Mirrors ``repro.nn.recurrent``: one fused gate product ``x @ wi + h @ wh +
b`` split as ``i, f, g, o``, with +1.0 added to the forget gate's
pre-activation. ``torch.nn.LSTM`` and cuDNN's LSTM are not this cell: they
carry two biases and no forget offset. ``lstm_scan`` is a Python loop over
T of the same cell, the counterpart of the reference's ``lax.scan``.
"""

import torch
from torch import nn

from repro_torch.device import resolve
from repro_torch.nn import init as inits


class LSTM(nn.Module):
    """wi (d_in, 4 d), wh (d, 4 d), b (4 d): the JAX package's layout."""

    def __init__(self, d_in, d_hidden, *, gen=None, dtype=torch.float32, device="cpu"):
        super().__init__()

        def mk(init, shape):
            return nn.Parameter(init(gen, shape, dtype, device), requires_grad=False)
        self.wi = mk(inits.fan_in(), (d_in, 4 * d_hidden))
        self.wh = mk(inits.fan_in(), (d_hidden, 4 * d_hidden))
        self.b = mk(inits.zeros, (4 * d_hidden,))


def lstm_step(p, x, state):
    """x (B, d_in); state (h, c) each (B, d_hidden)."""
    h, c = state
    gates = x @ p.wi + h @ p.wh + p.b
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, (h, c)


def lstm_scan(p, xs, state):
    """xs (B, T, d_in) -> (hs (B, T, d_hidden), final_state)."""
    hs = []
    for t in range(xs.shape[1]):
        h, state = lstm_step(p, xs[:, t], state)
        hs.append(h)
    return torch.stack(hs, dim=1), state


def lstm_state_init(batch, d_hidden, dtype=torch.float32, device="cuda"):
    dev = resolve(device)
    return (torch.zeros((batch, d_hidden), dtype=dtype, device=dev),
            torch.zeros((batch, d_hidden), dtype=dtype, device=dev))
