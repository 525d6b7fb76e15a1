"""CartPole (classic control), batched over E lanes on a torch device,
auto-resetting.

Mirrors ``repro.envs.cartpole``, whose pure-JAX env is vmapped over the
lanes. Here one call steps every lane: the state is a `CartPoleState` of an
(E, 4) float32 tensor ``s`` (x, x_dot, theta, theta_dot) and an (E,) step
count ``t`` on the env's device, and `reset` and `step` draw from an
explicit ``torch.Generator`` on that device (uniform(-0.05, 0.05) for every
lane each step, kept where a lane ends, as the reference draws a reset
state each step). The physics are the reference's, in fp32.
"""

import math
from typing import NamedTuple

import torch

from repro_torch.device import resolve

GRAVITY, MASSCART, MASSPOLE, LENGTH = 9.8, 1.0, 0.1, 0.5
FORCE_MAG, TAU = 10.0, 0.02
THETA_LIMIT, X_LIMIT = 12 * 2 * math.pi / 360, 2.4
MAX_STEPS = 200


class CartPoleState(NamedTuple):
    s: torch.Tensor    # (E, 4) float32: x, x_dot, theta, theta_dot
    t: torch.Tensor    # (E,) int64 steps into the episode


class CartPoleEnv:
    num_actions = 2
    obs_shape = (4,)

    def __init__(self, device="cuda"):
        self.device = resolve(device)

    def _draw(self, n, gen):
        return torch.empty((n, 4), device=self.device).uniform_(-0.05, 0.05, generator=gen)

    def reset(self, num_envs: int, gen: torch.Generator):
        st = CartPoleState(s=self._draw(num_envs, gen),
                           t=torch.zeros((num_envs,), dtype=torch.int64, device=self.device))
        return st, st.s

    def step(self, st: CartPoleState, action: torch.Tensor, gen: torch.Generator):
        """(state, obs, reward, done) over the lanes; reward 1 on a lane that
        goes on, 0 on one that ends (the pole past 12 degrees, the cart past
        2.4, or 200 steps), which restarts from a fresh draw."""
        x, x_dot, th, th_dot = st.s.unbind(1)
        force = torch.where(action == 1, FORCE_MAG, -FORCE_MAG)
        total_m = MASSCART + MASSPOLE
        pm_l = MASSPOLE * LENGTH
        sin, cos = torch.sin(th), torch.cos(th)
        temp = (force + pm_l * th_dot ** 2 * sin) / total_m
        th_acc = (GRAVITY * sin - cos * temp) / \
            (LENGTH * (4.0 / 3.0 - MASSPOLE * cos ** 2 / total_m))
        x_acc = temp - pm_l * th_acc * cos / total_m
        s = torch.stack([x + TAU * x_dot, x_dot + TAU * x_acc,
                         th + TAU * th_dot, th_dot + TAU * th_acc], dim=1)
        t = st.t + 1
        done = (s[:, 0].abs() > X_LIMIT) | (s[:, 2].abs() > THETA_LIMIT) | (t >= MAX_STEPS)
        s_reset = self._draw(done.shape[0], gen)
        new = CartPoleState(s=torch.where(done[:, None], s_reset, s),
                            t=torch.where(done, 0, t))
        return new, new.s, torch.where(done, 0.0, 1.0), done
