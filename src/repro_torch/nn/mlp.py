"""Gated MLP (SwiGLU / GeGLU) and the plain, ungated MLP (the
encoder-decoder's ReLU MLP), with optional biases. Mirrors
``repro.nn.mlp``.

``jax.nn.gelu`` defaults to the tanh approximation, and the JAX package
takes that default under both names, so both are ``approximate="tanh"``
here (PyTorch's default is the exact erf form)."""

import contextlib
import functools

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.nn import init as inits
from repro_torch.sharding.ctx import constrain
from repro_torch.sharding.param import ParamMaker

ACTS = {"silu": F.silu,
        "gelu": functools.partial(F.gelu, approximate="tanh"),
        "gelu_tanh": functools.partial(F.gelu, approximate="tanh"),
        "relu": F.relu}


class MLP(nn.Module):
    """wi (d, d_ff), wo (d_ff, d), with `gated` wg (d, d_ff) and, with
    `bias`, bi (d_ff,) and bo (d,): the JAX package's layout."""

    def __init__(self, d, d_ff, *, gated=True, bias=False, gen=None, dtype=torch.float32,
                 device="cpu"):
        super().__init__()

        mk = ParamMaker(self, gen, dtype, device)
        self.wi = mk("wi", (d, d_ff), ("embed", "mlp"), inits.fan_in())
        self.wo = mk("wo", (d_ff, d), ("mlp", "embed"), inits.fan_in())
        self.wg = mk("wg", (d, d_ff), ("embed", "mlp"), inits.fan_in()) if gated else None
        self.bi = self.bo = None
        if bias:
            self.bi = mk("bi", (d_ff,), ("mlp",), inits.zeros)
            self.bo = mk("bo", (d,), ("embed",), inits.zeros)


def mlp(p, x, act="silu"):
    dt = x.dtype
    h = x @ p.wi.to(dt)
    if p.bi is not None:
        h = h + p.bi.to(dt)
    h = ACTS[act](h)
    if p.wg is not None:
        h = h * (x @ p.wg.to(dt))
    h = constrain(h, "act_batch", "act_seq", "act_mlp")
    y = h @ p.wo.to(dt)
    if p.bo is not None:
        y = y + p.bo.to(dt)
    return y


@contextlib.contextmanager
def relu_masks(masks=None):
    """The ReLU MLP's activation (``ACTS["relu"]``, the encoder-decoder's)
    with its sign masks recorded in call order into the list yielded
    (`masks` None), or replayed from `masks` (h * mask: the same value and
    gradient wherever the two runs agree on the sign), for comparing the
    gradients of two runs only. ReLU's gradient jumps at 0: a
    pre-activation within rounding of 0 takes another sign under another
    rounding, and moves its leaf by one token's share."""
    saved, out = ACTS["relu"], []
    replay = None if masks is None else iter(masks)

    def act(h):
        if replay is not None:
            return h * next(replay).to(h.dtype)
        out.append(h.detach() > 0)
        return F.relu(h)
    ACTS["relu"] = act
    try:
        yield out
    finally:
        ACTS["relu"] = saved
