"""Shared model scaffolding: bundles, outputs, the value head and remat."""

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.utils.checkpoint
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


def maybe_remat(fn, remat: str):
    """`fn` (one layer) under the config's remat policy, as the reference's
    ``maybe_remat``: "none" keeps every activation; "full" saves only the
    layer's inputs and recomputes the rest in the backward
    (``torch.utils.checkpoint``, non-reentrant), when grad mode is on.
    The models apply it in train mode (``forward``) only."""
    if remat == "none":
        return fn
    if remat == "dots":
        raise NotImplementedError("remat='dots' (save only the matmuls' outputs) is not "
                                  "ported: no config uses it")
    if remat != "full":
        raise ValueError(f"unknown remat policy {remat!r}")

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return run


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
