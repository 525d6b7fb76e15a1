"""Shared model scaffolding: bundles, outputs, the value and q heads, the
modality frontend's projection and remat."""

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.utils.checkpoint
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts
from torch import nn

from repro_torch.nn import init as inits
from repro_torch.nn.embed import unembed
from repro_torch.nn.norms import apply_norm
from repro_torch.sharding.param import ParamMaker


class ValueHead(nn.Module):
    """w (d, 1), b (1,): the JAX package's layout."""

    def __init__(self, d, *, gen=None, dtype=torch.float32, device="cpu"):
        super().__init__()
        mk = ParamMaker(self, gen, dtype, device)
        self.w = mk("w", (d, 1), ("embed", None), inits.fan_in())
        self.b = mk("b", (1,), (None,), inits.zeros)


class QHead(nn.Module):
    """w (d, A), b (A,): the R2D2 q head of ``repro.models.common``."""

    def __init__(self, d, n_actions, *, gen=None, dtype=torch.float32, device="cpu"):
        super().__init__()
        mk = ParamMaker(self, gen, dtype, device)
        self.w = mk("w", (d, n_actions), ("embed", None), inits.fan_in())
        self.b = mk("b", (n_actions,), (None,), inits.zeros)


class FrontendProj(nn.Module):
    """w (frontend_dim, d): the modality stub's projection of precomputed
    patch or frame embeddings to d_model (``init_frontend_proj``)."""

    def __init__(self, cfg, *, gen=None, dtype=torch.float32, device="cpu"):
        super().__init__()
        self.w = ParamMaker(self, gen, dtype, device)(
            "w", (cfg.frontend_dim, cfg.d_model), (None, "embed"), inits.fan_in())


# Products that JAX calls a ``dot_general`` with no batch dimensions.
_BATCH_FREE = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
               torch.ops.aten.mv.default, torch.ops.aten.dot.default)


def dots_with_no_batch_dims_saveable(ctx, op, *args, **kwargs):
    """The port's counterpart of ``jax.checkpoint_policies.
    dots_with_no_batch_dims_saveable``, as a policy of
    ``torch.utils.checkpoint.create_selective_checkpoint_contexts``.

    Saved (``MUST_SAVE``): the outputs of the products with no batch
    dimension, ``aten.mm``, ``aten.addmm``, ``aten.mv`` and ``aten.dot``;
    ``x @ w`` on (..., D) activations and a (D, F) weight folds to ``mm``
    (``torch.matmul`` would take a ``bmm`` on an expanded weight only for
    activations it could not fold without a copy, which no layer of the
    port passes). Recomputed (``PREFER_RECOMPUTE``): every other op,
    batched products (``bmm``, ``baddbmm``: the experts' stacked GEMMs,
    attention's plain version) and every elementwise op and allocation. The
    kernels are ``ctypes`` calls that the policy never sees: their autograd
    Functions' forwards re-run in the recompute, as under "full".

    Against the reference's saved set (``saved_residuals`` of the JAX
    package's layers, less what "full" saves): this one contains it. JAX
    keeps a product only where the backward of its rematted unit reads it;
    this policy also keeps each unit's last product (an MLP's down
    projection, Mamba2's out projection), which only the residual add that
    ends the unit reads. ``tests/test_torch_remat.py`` lists the extras per
    family. The router's product is saved, so the recompute's expert
    choices are the forward's by construction."""
    if op in _BATCH_FREE:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(dots_with_no_batch_dims_saveable)


def maybe_remat(fn, remat: str):
    """`fn` (one layer) under the config's remat policy, as the reference's
    ``maybe_remat``: "none" keeps every activation; "full" saves only the
    layer's inputs and recomputes the rest in the backward; "dots" also
    saves the products with no batch dimension
    (``dots_with_no_batch_dims_saveable``) and recomputes the rest. Both
    run ``torch.utils.checkpoint`` (non-reentrant) when grad mode is on.
    The models apply it in train mode (``forward``) only."""
    if remat == "none":
        return fn
    if remat not in ("full", "dots"):
        raise ValueError(f"unknown remat policy {remat!r}")
    extra = {"context_fn": _dots_context} if remat == "dots" else {}

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False, **extra)
    return run


def value_head(p, x):
    return (x.float() @ p.w.float() + p.b.float())[..., 0]


def q_head(p, x):
    return x.float() @ p.w.float() + p.b.float()


def lm_outputs(cfg, params, x, aux_loss=0.0, mtp_logits=None):
    """Final norm, then the fp32 logits (capped by `cfg.final_softcap`) and
    the value of every position, with `aux_loss` and `mtp_logits` passed
    through. A model with a q head (R2D2) returns its q values (B,S,A) as
    the logits."""
    h = apply_norm(params.final_norm, x, cfg.norm_eps, cfg.gemma_scale)
    if getattr(params, "q_head", None) is not None:
        logits = q_head(params.q_head, h)
    else:
        logits = unembed(cfg, params.embed, h, softcap=cfg.final_softcap)
    return ModelOutputs(logits=logits, value=value_head(params.value_head, h),
                        aux_loss=aux_loss, mtp_logits=mtp_logits)


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
    """`aux_loss` is the LM's summed router loss, a 0-d fp32 tensor (zero for
    a dense LM), and the plain 0.0 of the families that have no router, as
    in the reference, whose loss adds the router term only for a
    one-element array. `mtp_logits` (B, S, vocab) fp32, the MTP head's
    prediction of token t+2, in `forward` of a model with MTP only."""
    logits: torch.Tensor            # (B, S, vocab) fp32 (or (B, S, A) for q-nets)
    value: Optional[torch.Tensor]   # (B, S) fp32
    aux_loss: Any = 0.0
    mtp_logits: Optional[torch.Tensor] = None
