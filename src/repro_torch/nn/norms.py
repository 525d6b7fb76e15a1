"""RMSNorm. (LayerNorm and the gemma-style (1+scale) option of
``repro.nn.norms`` come with the slices whose models use them.)"""

import torch
from torch import nn

from repro_torch.nn import init as inits


class Norm(nn.Module):
    """Holds `scale`; `apply_norm` computes."""

    def __init__(self, d, *, gen=None, dtype=torch.float32, device="cpu"):
        super().__init__()
        self.scale = nn.Parameter(inits.ones(gen, (d,), dtype, device),
                                  requires_grad=False)


def apply_norm(p, x, eps=1e-6):
    """RMSNorm in fp32, cast back to the input dtype."""
    xf = x.float()
    y = xf * (xf.square().mean(-1, keepdim=True) + eps) ** -0.5
    return (y * p.scale.float()).to(x.dtype)
