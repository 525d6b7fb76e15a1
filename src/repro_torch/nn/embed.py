"""Token embedding table (vocab padded to the TP degree) + logits head,
with gemma's embedding scale. (The final softcap of ``repro.nn.embed``
comes with the gemma2 slice.)"""

import math

import torch
from torch import nn

from repro_torch.device import dtype_of
from repro_torch.nn import init as inits


class Embed(nn.Module):
    """`table` (padded_vocab, d) and, unless `cfg.tie_embeddings`, `unembed`
    (d, padded_vocab): the JAX package's layout and names."""

    def __init__(self, cfg, *, gen=None, dtype=torch.float32, device="cpu"):
        super().__init__()
        v, d = cfg.padded_vocab, cfg.d_model
        self.table = nn.Parameter(inits.normal(1.0)(gen, (v, d), dtype, device),
                                  requires_grad=False)
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(inits.fan_in()(gen, (d, v), dtype, device),
                                        requires_grad=False)


def embed(cfg, p, tokens, scale_by_dim=False):
    x = p.table[tokens]
    if scale_by_dim:  # gemma convention, in the table's dtype as in the JAX package
        x = x * math.sqrt(cfg.d_model)
    return x.to(dtype_of(cfg.compute_dtype))


def unembed(cfg, p, x):
    """x (B,S,d) -> fp32 logits (B,S,padded_vocab); padded ids masked to -1e30.
    Tied embeddings read the table transposed (a view, not a copy)."""
    w = p.table.t() if cfg.tie_embeddings else p.unembed
    logits = (x @ w.to(x.dtype)).float()
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits
