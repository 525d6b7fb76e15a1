"""ALE stand-in with *configurable per-step CPU cost*.

A copy of ``repro.envs.alesim`` (numpy only): the port keeps its own so
that it imports nothing of the JAX package.

The paper's Fig 3 measures how actor (environment) throughput limits
end-to-end RL training. ALE itself is not available offline, so this host
(numpy) environment emulates an Atari game loop: it produces 84x84x4
frames and burns a calibratable amount of CPU per step, so the actor-count
sweep measures real contention on real hardware threads — the quantity the
paper studies — rather than game logic.
"""

import numpy as np


class FlatSimEnv:
    """ALESimEnv's CPU burn behind a *flat* float32 observation.

    The autoscaler e2e needs an env that is simultaneously (a) expensive
    enough per step that the run is actor-bound on a small core budget,
    (b) flat-obs so the vtrace MLP learner consumes it unchanged, and
    (c) a picklable module-level class so spawned actor hosts can
    construct it. CatchEnv is flat but free; ALESimEnv burns CPU but
    emits rank-3 frames. This is the intersection: the same calibratable
    dot-product workload, rendered as a 1-D state vector.
    """

    num_actions = 8
    auto_resets = True

    def __init__(self, obs_dim=64, step_cost=4096, episode_len=200, seed=0):
        self.obs_dim = obs_dim
        self.step_cost = step_cost
        self.episode_len = episode_len
        self.reseed(seed)

    def reseed(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self._work = self.rng.random((self.step_cost,)).astype(np.float32)
        self.t = 0
        self._state = self.rng.random((self.obs_dim,)).astype(np.float32)

    @property
    def obs_shape(self):
        return (self.obs_dim,)

    def _burn(self, action):
        w = self._work
        acc = float(np.dot(w, np.roll(w, action + 1)))
        self._state = np.abs(np.roll(self._state, 1) * 0.999 + 1e-4 * acc)
        self._state[0] = acc % 1.0

    def reset(self):
        self.t = 0
        self._state = self.rng.random((self.obs_dim,)).astype(np.float32)
        return self._state.copy()

    def step(self, action: int):
        self._burn(int(action))
        self.t += 1
        done = self.t >= self.episode_len
        reward = float(self._state[0] > 0.5)
        obs = self._state.copy()
        if done:
            obs = self.reset()
        return obs, reward, done


class ALESimEnv:
    num_actions = 18  # full ALE action set
    auto_resets = True  # step() returns the next episode's obs on done

    def __init__(self, frame=84, channels=4, step_cost=4096, episode_len=1000,
                 seed=0):
        """step_cost: size of the per-step numpy workload (~game emulation)."""
        self.frame, self.channels = frame, channels
        self.step_cost = step_cost
        self.episode_len = episode_len
        self.reseed(seed)

    def reseed(self, seed: int):
        """Re-derive all stochastic state; lets a vector wrapper decorrelate
        lanes built from one factory (see `repro_torch.envs.vector`)."""
        self.rng = np.random.default_rng(seed)
        self._work = self.rng.random((self.step_cost,)).astype(np.float32)
        self.t = 0
        self._state = self.rng.random((self.frame, self.frame)).astype(np.float32)

    @property
    def obs_shape(self):
        return (self.frame, self.frame, self.channels)

    def _render(self):
        f = (self._state * 255).astype(np.uint8)
        return np.stack([np.roll(f, i, axis=0) for i in range(self.channels)],
                        axis=-1)

    def _burn(self, action):
        # deterministic CPU work standing in for game emulation
        w = self._work
        acc = float(np.dot(w, np.roll(w, action + 1)))
        self._state = np.abs(np.roll(self._state, 1, axis=1) * 0.999
                             + 1e-4 * acc)
        self._state[0, 0] = acc % 1.0

    def reset(self):
        self.t = 0
        self._state = self.rng.random((self.frame, self.frame)).astype(np.float32)
        return self._render()

    def step(self, action: int):
        self._burn(int(action))
        self.t += 1
        done = self.t >= self.episode_len
        reward = float(self._state[0, 0] > 0.5)  # pseudo-reward
        obs = self._render()
        if done:
            obs = self.reset()
        return obs, reward, done
