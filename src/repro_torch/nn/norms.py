"""RMSNorm / LayerNorm, with the gemma-style (1+scale) option.

Mirrors ``repro.nn.norms``: a LayerNorm holds a bias beside its scale."""

import torch
from torch import nn

from repro_torch.nn import init as inits
from repro_torch.sharding.param import ParamMaker

KINDS = ("rmsnorm", "layernorm")


class Norm(nn.Module):
    """Holds `scale` (and `bias` for a layernorm); `apply_norm` computes.
    With `gemma_scale` the scale starts at zeros and the norm multiplies by
    (1 + scale), as gemma's."""

    def __init__(self, d, *, kind="rmsnorm", gemma_scale=False, gen=None,
                 dtype=torch.float32, device="cpu", axis="embed"):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(f"norm kind {kind!r} not in {KINDS}")
        self.kind = kind
        mk = ParamMaker(self, gen, dtype, device)
        self.scale = mk("scale", (d,), (axis,), inits.zeros if gemma_scale else inits.ones)
        self.bias = mk("bias", (d,), (axis,), inits.zeros) if kind == "layernorm" else None


def apply_norm(p, x, eps=1e-6, gemma_scale=False):
    """The norm in fp32, cast back to the input dtype."""
    xf = x.float()
    if p.kind == "rmsnorm":
        y = xf * (xf.square().mean(-1, keepdim=True) + eps) ** -0.5
    else:
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) / torch.sqrt(var + eps)
    scale = p.scale.float()
    y = y * (1.0 + scale) if gemma_scale else y * scale
    if p.bias is not None:
        y = y + p.bias.float()
    return y.to(x.dtype)
