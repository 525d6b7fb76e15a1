"""V-trace off-policy correction (IMPALA, Espeholt et al. 2018).

Mirrors ``repro.core.vtrace``: batch-major (B, T). The reverse scan over T
is a Python loop (T is at most a few hundred); ``vs`` and
``pg_advantages`` are detached, as the reference's ``stop_gradient`` is.
"""

from typing import NamedTuple

import torch


class VTraceReturns(NamedTuple):
    vs: torch.Tensor             # (B, T) corrected value targets
    pg_advantages: torch.Tensor  # (B, T)
    rhos: torch.Tensor           # (B, T) truncated importance weights


def vtrace(target_logprobs, behavior_logprobs, rewards, discounts, values,
           bootstrap_value, *, rho_bar=1.0, c_bar=1.0):
    """All inputs (B, T); bootstrap_value (B,). Returns VTraceReturns.

    discounts: gamma * (1 - done) at each step (0 at terminal).
    """
    log_rhos = target_logprobs - behavior_logprobs
    rhos = torch.clamp(torch.exp(log_rhos), max=rho_bar)
    cs = torch.clamp(torch.exp(log_rhos), max=c_bar)

    values_tp1 = torch.cat([values[:, 1:], bootstrap_value[:, None]], dim=1)
    deltas = rhos * (rewards + discounts * values_tp1 - values)

    acc = torch.zeros_like(bootstrap_value)
    out = [None] * deltas.shape[1]
    for t in range(deltas.shape[1] - 1, -1, -1):
        acc = deltas[:, t] + discounts[:, t] * cs[:, t] * acc
        out[t] = acc
    vs = values + torch.stack(out, dim=1)

    vs_tp1 = torch.cat([vs[:, 1:], bootstrap_value[:, None]], dim=1)
    pg_adv = rhos * (rewards + discounts * vs_tp1 - values)
    return VTraceReturns(vs=vs.detach(), pg_advantages=pg_adv.detach(), rhos=rhos)


def vtrace_losses(target_logprobs, entropy, vtr: VTraceReturns, values, mask,
                  *, value_coef=0.5, entropy_coef=0.01):
    """Scalar (policy, value, entropy) losses, mean over masked steps."""
    denom = torch.clamp(mask.sum(), min=1.0)
    pg = -(target_logprobs * vtr.pg_advantages * mask).sum() / denom
    vl = 0.5 * (torch.square(vtr.vs - values) * mask).sum() / denom
    en = -(entropy * mask).sum() / denom
    return pg, value_coef * vl, entropy_coef * en
