"""Vectorized environments: E env lanes behind one `step()` call.

A copy of the host half of ``repro.envs.vector`` (numpy only): the port
keeps its own so that it imports nothing of the JAX package. In place of
its `JaxVectorEnv` (``jax.vmap`` + ``jit`` over a pure-JAX env, the lane
batch advanced in one device call), `TorchVectorEnv` steps a batched
torch env (`envs.catch.CatchEnv`, `envs.cartpole.CartPoleEnv`,
`envs.tokenworld.TokenWorld`) in one call on the env's device.
`make_vector_env` refuses a keyed env that is neither.

The paper's central quantity — env-interaction throughput per CPU thread —
is dominated by per-step overhead: one inference round-trip and one Python
dispatch per frame. `SyncVectorEnv` loops E host (numpy) envs such as
`ALESimEnv` in one Python call, with per-lane auto-reset: one inference
request carries E observations, though E Python step calls remain.

The host-facing contract, the only one actors see:

    reset()        -> obs[E, ...]
    step(actions)  -> (obs[E, ...], rewards[E], dones[E])

Lanes never block each other: a `done` lane is reset in place (by the env
itself when it auto-resets, by the wrapper otherwise) and the returned obs
for that lane is the first observation of the next episode.
"""

import inspect
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch


class VectorEnv:
    """Interface: E independent env lanes stepped as one batch."""

    num_envs: int
    num_actions: int
    obs_shape: tuple

    def reset(self) -> np.ndarray:
        raise NotImplementedError

    def step(self, actions) -> tuple:
        raise NotImplementedError


class SyncVectorEnv(VectorEnv):
    """Loop E host envs (`reset() -> obs`, `step(a) -> (obs, r, done)`).

    Per-lane auto-reset: when lane i reports done, it is reset before the
    next step so no lane ever idles. Envs that already auto-reset (declare
    `auto_resets = True`, e.g. `ALESimEnv`) are not reset a second time.
    """

    def __init__(self, env_factory: Union[Callable, Sequence], num_envs: int = 1,
                 envs: Optional[Sequence] = None, seed: Optional[int] = None):
        if envs is not None:
            self.envs = list(envs)
        elif callable(env_factory):
            self.envs = [env_factory() for _ in range(num_envs)]
        else:  # a single pre-built env only supports one lane
            if num_envs != 1:
                raise ValueError(
                    f"got a single pre-built env with num_envs={num_envs}: "
                    f"one host env instance cannot back {num_envs} "
                    f"independent lanes (they would share mutable state). "
                    f"Pass a factory (e.g. lambda: {type(env_factory).__name__}(...)) "
                    f"or explicit envs=[...] instead.")
            self.envs = [env_factory]
        self.num_envs = len(self.envs)
        self.num_actions = self.envs[0].num_actions
        self.obs_shape = tuple(self.envs[0].obs_shape)
        self._auto = [bool(getattr(e, "auto_resets", False)) for e in self.envs]
        if seed is not None:
            # decorrelate lanes built from one factory: a factory closes over
            # fixed ctor args, so without this every lane is an exact clone
            for i, e in enumerate(self.envs):
                if hasattr(e, "reseed"):
                    e.reseed(seed * 1_000_003 + i)

    def reset(self):
        return np.stack([np.asarray(e.reset()) for e in self.envs])

    def step(self, actions):
        actions = np.asarray(actions)
        assert actions.shape[0] == self.num_envs, actions.shape
        obs, rewards, dones = [], [], []
        for i, env in enumerate(self.envs):
            o, r, d = env.step(int(actions[i]))
            if d and not self._auto[i]:
                o = env.reset()          # per-lane auto-reset
            obs.append(np.asarray(o))
            rewards.append(r)
            dones.append(d)
        return (np.stack(obs), np.asarray(rewards, np.float32),
                np.asarray(dones, bool))


class TorchVectorEnv(VectorEnv):
    """E lanes of a batched torch env (`reset(E, gen) -> (state, obs)`,
    `step(state, a, gen) -> (state, obs, reward, done)`, every tensor on
    ``env.device``), the counterpart of the reference's `JaxVectorEnv`.

    The state lives on the env's device; each `step()` is one batched call
    over all E lanes, then one copy of obs, rewards and dones to the host.
    The env auto-resets inside `step`, so lanes never stall. The lanes draw
    from one ``torch.Generator`` on the env's device seeded with `seed`.
    """

    def __init__(self, env, num_envs: int, seed: int = 0):
        self.env = env
        self.num_envs = num_envs
        self.num_actions = env.num_actions
        self.obs_shape = tuple(env.obs_shape)
        self._gen = torch.Generator(device=env.device)
        self._gen.manual_seed(seed)
        self._state = None

    def reset(self):
        self._state, obs = self.env.reset(self.num_envs, self._gen)
        return obs.cpu().numpy()

    def step(self, actions):
        assert self._state is not None, "call reset() before step()"
        a = torch.as_tensor(np.asarray(actions), dtype=torch.int64).to(self.env.device)
        self._state, obs, reward, done = self.env.step(self._state, a, self._gen)
        # one copy to the host: obs, then reward and done as two columns, in
        # fp32 (TokenWorld's int64 tokens are exact there, and come back int)
        host = torch.cat([obs.reshape(self.num_envs, -1).to(reward.dtype), reward[:, None],
                          done[:, None].to(reward.dtype)], dim=1).cpu().numpy()
        obs_host = host[:, :-2].reshape((self.num_envs,) + self.obs_shape)
        if not obs.is_floating_point():
            obs_host = obs_host.astype(np.int64)
        return obs_host, host[:, -2].astype(np.float32), host[:, -1].astype(bool)


def _is_torch_env(env) -> bool:
    """A batched torch env carries the torch.device its lanes live on."""
    return isinstance(getattr(env, "device", None), torch.device)


def _is_jax_env(env) -> bool:
    """Pure-JAX envs take a PRNG key in reset(); host envs take nothing."""
    try:
        return len(inspect.signature(env.reset).parameters) >= 1
    except (TypeError, ValueError):
        return False


def as_env_instance(env) -> tuple:
    """Normalize (factory | class | instance) -> (instance, was_factory).

    The single factory-detection rule of the host backend
    (`make_vector_env`); the device backend (`rollout.engine.as_torch_env`)
    shares it.
    """
    is_factory = callable(env) and (inspect.isclass(env)
                                    or not hasattr(env, "reset"))
    return (env() if is_factory else env), is_factory


def make_vector_env(env, num_envs: int = 1, seed: int = 0) -> VectorEnv:
    """Normalize (factory | env | VectorEnv) into a VectorEnv of E lanes.

    Batched torch envs go through `TorchVectorEnv`, host envs through
    `SyncVectorEnv`; an existing VectorEnv passes through. Other keyed
    envs (a pure-JAX-style reset(key)) are refused: the port batches no
    env it cannot step in torch.
    """
    if isinstance(env, VectorEnv):
        return env
    instance, is_factory = as_env_instance(env)
    if isinstance(instance, VectorEnv):
        return instance
    if _is_torch_env(instance):
        return TorchVectorEnv(instance, num_envs, seed=seed)
    if _is_jax_env(instance):
        raise NotImplementedError(
            f"{type(instance).__name__} takes a key in reset(): a pure-JAX-style "
            f"keyed env has no torch counterpart to batch it (JaxVectorEnv in the "
            f"JAX package); TorchVectorEnv and the device backend take a batched "
            f"torch env such as envs.catch.CatchEnv, envs.cartpole.CartPoleEnv or "
            f"envs.tokenworld.TokenWorld, SyncVectorEnv a host env such as ALESimEnv")
    if is_factory:
        envs = [instance] + [env() for _ in range(num_envs - 1)]
        return SyncVectorEnv(None, envs=envs, seed=seed)
    # pre-built env: the caller chose its state (incl. seed) — leave it alone
    return SyncVectorEnv(instance, num_envs)
