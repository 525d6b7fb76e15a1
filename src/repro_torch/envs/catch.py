"""Catch: the classic tabula-rasa RL testbed (rows x cols grid, falling
ball, 3-action paddle), batched over E lanes on a torch device.

Mirrors ``repro.envs.catch``, whose pure-JAX env is vmapped over the lanes
on the accelerator (`JaxVectorEnv`). Here one call steps every lane: the
state is a `CatchState` of (E,) integer tensors on the env's device, and
`reset` and `step` draw from an explicit ``torch.Generator`` on that
device. `envs.vector.TorchVectorEnv` holds the state and the generator.
"""

from typing import NamedTuple

import torch

from repro_torch.device import resolve


class CatchState(NamedTuple):
    ball_r: torch.Tensor
    ball_c: torch.Tensor
    paddle: torch.Tensor


class CatchEnv:
    num_actions = 3

    def __init__(self, rows=10, cols=5, device="cuda"):
        self.rows, self.cols = rows, cols
        self.obs_shape = (rows * cols,)
        self.device = resolve(device)

    def _columns(self, n, gen):
        return torch.randint(0, self.cols, (n,), generator=gen, device=self.device)

    def reset(self, num_envs: int, gen: torch.Generator):
        st = CatchState(
            ball_r=torch.zeros((num_envs,), dtype=torch.int64, device=self.device),
            ball_c=self._columns(num_envs, gen),
            paddle=self._columns(num_envs, gen))
        return st, self.obs(st)

    def obs(self, st: CatchState) -> torch.Tensor:
        """(E, rows*cols) float32 one-hot grid of the ball and the paddle."""
        grid = torch.zeros((st.ball_r.shape[0], self.rows * self.cols), device=self.device)
        grid.scatter_(1, (st.ball_r * self.cols + st.ball_c)[:, None], 1.0)
        grid.scatter_(1, ((self.rows - 1) * self.cols + st.paddle)[:, None], 1.0)
        return grid

    def step(self, st: CatchState, action: torch.Tensor, gen: torch.Generator):
        """(state, obs, reward, done) over the lanes; a lane that is done
        auto-resets: ball at row 0, new ball column and paddle drawn."""
        paddle = torch.clamp(st.paddle + action - 1, 0, self.cols - 1)
        ball_r = st.ball_r + 1
        done = ball_r >= self.rows - 1
        reward = torch.where(done, torch.where(st.ball_c == paddle, 1.0, -1.0), 0.0)
        n = done.shape[0]
        new = CatchState(
            ball_r=torch.where(done, 0, ball_r),
            ball_c=torch.where(done, self._columns(n, gen), st.ball_c),
            paddle=torch.where(done, self._columns(n, gen), paddle))
        return new, self.obs(new), reward, done
