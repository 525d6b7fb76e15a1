"""AdamW / SGD as functional updates, with low-precision moments and
global-norm clipping. Mirrors ``repro.optim.adamw``.

Params, grads and moments are flat dicts name -> tensor (the names of
``nn.Module.named_parameters()``). As the JAX train step donates its state,
``update`` works in place: the grads' buffers become the updates (clipped,
scaled and signed) and the moments are updated in their own buffers, so a
step holds no second copy of the grads or the state; ``apply_updates`` adds
the updates to the params in place. Each leaf is updated in its own pass
rather than with ``torch._foreach_*`` over all of them, whose temporaries
would each be a full set of the params' size.

`step` is a Python int, so the learning rate and the bias corrections are
host floats and a step never waits on the device; the grad norm stays a
0-d device tensor.
"""

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.utils.tree import global_norm


@dataclass(frozen=True)
class Optimizer:
    init: Callable      # params -> opt_state
    update: Callable    # (grads, opt_state, params, step) -> (updates, opt_state, metrics)


@torch.no_grad()
def _clip_by_global_norm(grads, max_norm):
    """Scale `grads` in place to global norm at most `max_norm`; returns the
    norm before clipping."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in grads.values():
        g.mul_(scale.to(g.dtype))
    return norm


def adamw(lr, *, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0,
          max_grad_norm: Optional[float] = 1.0, moment_dtype=torch.float32):
    """lr: float or callable(step) -> float."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)  # noqa: E731
        return {"m": {k: zeros(p) for k, p in params.items()},
                "v": {k: zeros(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(grads, state, params, step):
        gnorm = None
        if max_grad_norm is not None:
            gnorm = _clip_by_global_norm(grads, max_grad_norm)
        stepf = float(step) + 1.0
        bc1, bc2 = 1.0 - b1 ** stepf, 1.0 - b2 ** stepf
        rate = lr_fn(step)
        for name, g in grads.items():
            m, v, p = state["m"][name], state["v"][name], params[name]
            gf = g.float()
            m32 = m.float().mul_(b1).add_(gf, alpha=1.0 - b1)
            v32 = v.float().mul_(b2).addcmul_(gf, gf, value=1.0 - b2)
            u = (m32 / bc1).div_(torch.sqrt(v32 / bc2).add_(eps))
            if weight_decay:
                u.add_(p.float(), alpha=weight_decay)
            g.copy_(u.mul_(-rate))
            m.copy_(m32)
            v.copy_(v32)
        if gnorm is None:
            gnorm = torch.zeros((), device=next(iter(grads.values())).device)
        return grads, state, {"grad_norm": gnorm}

    return Optimizer(init=init, update=update)


def sgd(lr, momentum=0.0, max_grad_norm=None):
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        if not momentum:
            return {}
        return {"mu": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(grads, state, params, step):
        gnorm = None
        if max_grad_norm is not None:
            gnorm = _clip_by_global_norm(grads, max_grad_norm)
        rate = lr_fn(step)
        for name, g in grads.items():
            if momentum:
                mu = state["mu"][name].mul_(momentum).add_(g)
                g.copy_(mu)
            g.mul_(-rate)
        if gnorm is None:
            gnorm = torch.zeros((), device=next(iter(grads.values())).device)
        return grads, state, {"grad_norm": gnorm}

    return Optimizer(init=init, update=update)


@torch.no_grad()
def apply_updates(params, updates):
    """p += u, in place, u cast to p's dtype; returns `params`."""
    for name, p in params.items():
        p.add_(updates[name].to(p.dtype))
    return params
