"""R2D2 loss (Kapturowski et al. 2019): recurrent replay distributed
Q-learning — burn-in, n-step double-Q targets, value-function rescaling,
and the mixed max/mean priority used by the prioritized replay buffer.

Mirrors ``repro.core.r2d2``. ``jnp.roll`` becomes ``torch.roll``, with the
same wraparound, cut off by the ``[:, :t-n]`` slice; the double-Q pick is
``torch.argmax``, which returns the first index of a tie as ``jnp.argmax``
does; ``jax.lax.stop_gradient`` becomes ``detach``.
"""

from typing import NamedTuple

import torch

EPS = 1e-3


def rescale(x):
    """h(x) = sign(x) (sqrt(|x|+1) - 1) + eps x."""
    return torch.sign(x) * (torch.sqrt(torch.abs(x) + 1.0) - 1.0) + EPS * x


def inv_rescale(x):
    """h^{-1}(x), closed form."""
    n = torch.sqrt(1.0 + 4.0 * EPS * (torch.abs(x) + 1.0 + EPS)) - 1.0
    return torch.sign(x) * (torch.square(n / (2.0 * EPS)) - 1.0)


class R2D2Out(NamedTuple):
    loss: torch.Tensor         # scalar
    priorities: torch.Tensor   # (B,), no gradient
    td_error: torch.Tensor     # (B, T-n), no gradient


def n_step_targets(q_target, q_online, actions, rewards, dones, *, n_step, gamma):
    """Double-Q n-step targets with value rescaling.

    q_target/q_online (B, T, A): target/online nets over the training
    (post-burn-in) segment; actions/rewards/dones (B, T).
    Returns targets (B, T-n) aligned with positions 0..T-n-1.
    """
    b, t, _ = q_online.shape
    best = torch.argmax(q_online, dim=-1)                      # (B,T) double-Q
    q_next = torch.gather(q_target, -1, best[..., None])[..., 0]
    q_next = inv_rescale(q_next)

    # returns_k = sum_{i<n} gamma^i r_{t+i} prod(1-d) + gamma^n Q(s_{t+n})
    ret = torch.zeros((b, t), dtype=q_online.dtype, device=q_online.device)
    disc = torch.ones_like(ret)
    alive = torch.ones_like(ret)
    for i in range(n_step):
        r_i = torch.roll(rewards, -i, dims=1)
        d_i = torch.roll(dones, -i, dims=1)
        ret = ret + disc * alive * r_i
        alive = alive * (1.0 - d_i)
        disc = disc * gamma
    q_boot = torch.roll(q_next, -n_step, dims=1)
    targets = ret + disc * alive * q_boot
    return rescale(targets[:, : t - n_step])


def r2d2_loss(q_online_burn, q_online, q_target, actions, rewards, dones, *,
              n_step=5, gamma=0.997, priority_exponent=0.9):
    """q_online (B,T,A) over training segment (burn-in already consumed by
    the caller when unrolling the net); actions/rewards/dones (B,T)."""
    del q_online_burn
    t = q_online.shape[1]
    targets = n_step_targets(q_target, q_online, actions, rewards, dones,
                             n_step=n_step, gamma=gamma)
    q_a = torch.gather(q_online, -1, actions[..., None].long())[..., 0]
    td = targets - q_a[:, : t - n_step]
    loss = 0.5 * torch.mean(torch.square(td))
    td = td.detach()
    abs_td = torch.abs(td)
    pri = (priority_exponent * abs_td.amax(dim=1)
           + (1.0 - priority_exponent) * abs_td.mean(dim=1))
    return R2D2Out(loss=loss, priorities=pri, td_error=td)
