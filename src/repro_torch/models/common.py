"""Shared model scaffolding: bundles, outputs and the value head."""

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
from torch import nn

from repro_torch.nn import init as inits
from repro_torch.nn.embed import unembed
from repro_torch.nn.norms import apply_norm


class ValueHead(nn.Module):
    """w (d, 1), b (1,): the JAX package's layout."""

    def __init__(self, d, *, gen=None, dtype=torch.float32, device="cpu"):
        super().__init__()
        self.w = nn.Parameter(inits.fan_in()(gen, (d, 1), dtype, device),
                              requires_grad=False)
        self.b = nn.Parameter(inits.zeros(gen, (1,), dtype, device),
                              requires_grad=False)


def value_head(p, x):
    return (x.float() @ p.w.float() + p.b.float())[..., 0]


def lm_outputs(cfg, params, x):
    """Final norm, then the fp32 logits and the value of every position."""
    h = apply_norm(params.final_norm, x, cfg.norm_eps, cfg.gemma_scale)
    return ModelOutputs(logits=unembed(cfg, params.embed, h),
                        value=value_head(params.value_head, h))


def as_tokens(params, tokens):
    """Token ids as int64 on the params' device."""
    return torch.as_tensor(tokens, device=params.device).long()


@dataclass
class ModelBundle:
    """Uniform functional interface every architecture family implements.
    `params` is the family's nn.Module."""
    cfg: Any
    init: Callable                  # (seed, device, dtype) -> params
    forward: Callable               # (params, batch) -> ModelOutputs
    init_cache: Callable            # (batch, max_len, dtype, device) -> cache
    prefill: Callable               # (params, batch, max_len, dtype) -> (outputs, cache)
    decode_step: Callable           # (params, tokens_t, cache) -> (outputs, cache)


@dataclass
class ModelOutputs:
    logits: torch.Tensor            # (B, S, vocab) fp32
    value: Optional[torch.Tensor]   # (B, S) fp32
