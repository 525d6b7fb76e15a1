"""RMSNorm, with the gemma-style (1+scale) option. (LayerNorm of
``repro.nn.norms`` comes with the slices whose models use it.)"""

import torch
from torch import nn

from repro_torch.nn import init as inits


class Norm(nn.Module):
    """Holds `scale`; `apply_norm` computes. With `gemma_scale` the scale
    starts at zeros and the norm multiplies by (1 + scale), as gemma's."""

    def __init__(self, d, *, gemma_scale=False, gen=None, dtype=torch.float32, device="cpu"):
        super().__init__()
        init = inits.zeros if gemma_scale else inits.ones
        self.scale = nn.Parameter(init(gen, (d,), dtype, device), requires_grad=False)


def apply_norm(p, x, eps=1e-6, gemma_scale=False):
    """RMSNorm in fp32, cast back to the input dtype."""
    xf = x.float()
    y = xf * (xf.square().mean(-1, keepdim=True) + eps) ** -0.5
    scale = p.scale.float()
    return (y * (1.0 + scale) if gemma_scale else y * scale).to(x.dtype)
