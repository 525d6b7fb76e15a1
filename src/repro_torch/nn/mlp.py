"""Gated MLP (SwiGLU / GeGLU). (Biases, relu and the plain MLP of
``repro.nn.mlp`` come with the slices whose models use them.)

``jax.nn.gelu`` defaults to the tanh approximation, and the JAX package
takes that default under both names, so both are ``approximate="tanh"``
here (PyTorch's default is the exact erf form)."""

import functools

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.nn import init as inits

ACTS = {"silu": F.silu,
        "gelu": functools.partial(F.gelu, approximate="tanh"),
        "gelu_tanh": functools.partial(F.gelu, approximate="tanh")}


class MLP(nn.Module):
    """wi, wg (d, d_ff) and wo (d_ff, d): the JAX package's layout."""

    def __init__(self, d, d_ff, *, gen=None, dtype=torch.float32, device="cpu"):
        super().__init__()

        def mk(shape):
            return nn.Parameter(inits.fan_in()(gen, shape, dtype, device),
                                requires_grad=False)
        self.wi = mk((d, d_ff))
        self.wo = mk((d_ff, d))
        self.wg = mk((d, d_ff))


def mlp(p, x, act="silu"):
    dt = x.dtype
    h = ACTS[act](x @ p.wi.to(dt)) * (x @ p.wg.to(dt))
    return h @ p.wo.to(dt)
