"""Token embedding table (vocab padded to the TP degree) + logits head,
with gemma's embedding scale and gemma2's final logit softcap."""

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


def unembed(cfg, p, x, softcap=None):
    """x (B,S,d) -> fp32 logits (B,S,padded_vocab), capped to
    softcap * tanh(logits / softcap) in fp32 with `softcap`; then padded
    ids masked to -1e30. Tied embeddings read the table transposed (a view,
    not a copy). Without grad mode the cap runs in place: at gemma2's
    vocab a 4 x 4352 prefill's logits take 17.8 GB, and out of place the
    cap would hold three such buffers at once."""
    w = p.table.t() if cfg.tie_embeddings else p.unembed
    logits = (x @ w.to(x.dtype)).float()
    if softcap:
        if torch.is_grad_enabled():
            logits = softcap * torch.tanh(logits / softcap)
        else:
            logits.div_(softcap).tanh_().mul_(softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits
