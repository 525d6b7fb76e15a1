"""Device-resident rollout engine: env step and policy forward fused into
one T-step unroll, replayed on a CUDA device as one CUDA graph.

Mirrors ``repro.rollout.engine``. The host-backed actor loop
(`core.actor`) pays one host<->device round trip per vector step:
observations come down, actions go up, T times per unroll.
`DeviceRolloutEngine` runs a batched torch env's `step` and the policy
forward for T steps over E lanes with the env state, the recurrent core,
the observations and both random generators on the device. The host sees
one transfer per unroll: the `(T, E, ...)` trajectory, packed into one
buffer on the device and copied back once.

The reference fuses the unroll with ``jax.jit(lax.scan)``. Here, on a CUDA
device, the T-step loop (about 30 small launches a step) is captured once
as a CUDA graph and replayed once per unroll. A graph reads fixed
addresses, so the engine keeps the carry in tensors it updates in place,
keeps its own copy of the params (the published params are copied into it
before each replay; a change of keys, shapes or dtypes captures anew and
counts in `captures`), and registers both generators with the graph so
that each replay advances them. A CUDA engine always captures, and raises
if capture or replay fails. On the CPU, which the tests use, the same loop
runs eagerly.

Determinism contract (what the parity tests pin down):
  * the lanes' env stream is one ``torch.Generator`` on the device seeded
    `seed`, as in `envs.vector.TorchVectorEnv`, so a step-by-step loop
    over the same generator produces the same trajectories;
  * the policy draws from a second generator, `action_generator(seed,
    device)`, once per step.
"""

import contextlib
import copy
import gc
import math
import threading
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.envs.vector import _is_torch_env, as_env_instance

# the action stream's seed is the env stream's plus this, modulo 2**32 (the
# CPU generator keeps only a seed's low 32 bits)
ACTION_STREAM = 0x9E3779B9
# eager unrolls on the capture stream before capture (cuBLAS handles and
# the caching allocator settle there), as PyTorch's recipe for graphs runs
WARMUP_UNROLLS = 3
# one capture at a time in the process (engines of several workers may
# capture lazily from their threads)
_CAPTURE_LOCK = threading.Lock()


def as_torch_env(env):
    """Normalize (factory | class | instance) into a batched torch env
    instance (`reset(num_envs, gen) -> (state, obs)`, lanes on
    ``env.device``); host envs cannot ride the device loop."""
    instance, _ = as_env_instance(env)
    if not _is_torch_env(instance):
        raise ValueError(
            f"backend='device' requires a batched torch env (reset(num_envs, gen) -> "
            f"(state, obs), its lanes on env.device); got {type(instance).__name__}, a "
            f"host env. Use the host backend, or port the env to torch.")
    return instance


def action_generator(seed: int, device) -> torch.Generator:
    """The engine's per-step action stream for `seed` (parity hook)."""
    return torch.Generator(device=device).manual_seed(_action_seed(seed))


def _action_seed(seed: int) -> int:
    return (ACTION_STREAM + seed) % (1 << 32)


def _indexed(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _tensors(tree) -> list:
    """The tensors of a tree of tensors and Nones, in order."""
    return [x for x in pytree.tree_leaves(tree) if x is not None]


def _map(fn, tree):
    return pytree.tree_map(lambda x: None if x is None else fn(x), tree)


def _signature(params):
    """What a captured graph depends on: the params' tree, shapes, dtypes."""
    leaves = _tensors(params)
    if not all(isinstance(x, torch.Tensor) for x in leaves):
        raise TypeError("params must be None or a tree of tensors")
    return pytree.tree_structure(params), tuple((tuple(x.shape), x.dtype) for x in leaves)


class DeviceRolloutEngine:
    """Fused env+policy unrolls for one batch of E lanes.

    policy_apply: (params, core, obs[E, ...], gen) -> (actions[E], core),
    or (actions, logprobs, core) with ``with_logprobs=True``, drawing from
    the ``torch.Generator`` `gen`; `core` is any tree of per-lane recurrent
    state (or None for feed-forward policies). One `rollout(params)` call
    advances all lanes T steps on the device and returns the host-side
    trajectory dict {obs (T,E,...) in the env's obs dtype, actions (T,E)
    int32, rewards (T,E) f32, dones (T,E) bool, and with logprobs
    behavior_logprobs (T,E) f32}.

    `device` places the engine (engine sharding): a copy of the env with
    that device. None keeps the env's own.
    """

    def __init__(self, env, policy_apply: Callable, num_envs: int,
                 unroll: int, *, init_core: Optional[Callable] = None,
                 seed: int = 0, device=None, with_logprobs: bool = False):
        env = as_torch_env(env)
        self.device = _indexed(env.device if device is None else device)
        if _indexed(env.device) != self.device:
            env = copy.copy(env)
            env.device = self.device
        self.env = env
        self.num_envs = num_envs
        self.unroll = unroll
        self.num_actions = env.num_actions
        self.obs_shape = tuple(getattr(env, "obs_shape", ()))
        self._policy = policy_apply
        self._init_core = init_core       # init_core(num_envs) -> core tree
        self._seed = seed
        # on-policy rollouts: the trajectory gains behavior_logprobs (T, E),
        # V-trace's denominator, from the same forward
        self.with_logprobs = with_logprobs
        self._env_gen = torch.Generator(device=self.device)
        self._act_gen = torch.Generator(device=self.device)
        self._carry = None                # (env_state, core, obs), updated in place
        self._carry_spec = None
        self._flat = None                 # the packed trajectory on the device
        self._fields = None               # (name, shape, dtype, byte offset, bytes)
        self._views = None
        self._graph = None
        self._params = None               # the graph's copy of the params
        self._signature = None
        self.scans = 0                    # device round trips (one per unroll)
        self.frames = 0                   # = scans * T * E
        self.captures = 0                 # CUDA graphs captured

    # ------------------------------------------------------------ the carry

    def reset(self) -> np.ndarray:
        """(Re)seed all lanes and both generators; returns the initial obs
        batch (E, ...)."""
        self._env_gen.manual_seed(self._seed)
        self._act_gen.manual_seed(_action_seed(self._seed))
        env_state, obs = self.env.reset(self.num_envs, self._env_gen)
        core = self._init_core(self.num_envs) if self._init_core else None
        core = _map(lambda x: x.to(self.device), core)
        if self._carry is None:
            # own tensors (an env may return one tensor as state and obs)
            self._carry = _map(torch.clone, (env_state, core, obs))
            self._carry_spec = pytree.tree_structure(self._carry)
            self._allocate_trajectory(obs)
        else:
            self._write_carry((env_state, core, obs))
        return obs.cpu().numpy()

    def _write_carry(self, carry):
        spec = pytree.tree_structure(carry)
        if spec != self._carry_spec:
            raise ValueError(f"the carry changed structure: {spec} (was {self._carry_spec})")
        for dst, src in zip(_tensors(self._carry), _tensors(carry)):
            dst.copy_(src)

    def _allocate_trajectory(self, obs):
        T, E = self.unroll, self.num_envs
        fields = [("obs", (T, E) + tuple(obs.shape[1:]), obs.dtype),
                  ("actions", (T, E), torch.int32), ("rewards", (T, E), torch.float32),
                  ("dones", (T, E), torch.bool)]
        if self.with_logprobs:
            fields.append(("behavior_logprobs", (T, E), torch.float32))
        self._fields, off = [], 0
        for name, shape, dtype in fields:
            nbytes = math.prod(shape) * dtype.itemsize
            self._fields.append((name, shape, dtype, off, nbytes))
            off += -(-nbytes // 8) * 8
        self._flat = torch.zeros((off,), dtype=torch.uint8, device=self.device)
        self._views = {name: self._flat[o:o + n].view(dtype).view(shape)
                       for name, shape, dtype, o, n in self._fields}

    def _snapshot(self):
        return ([x.clone() for x in _tensors(self._carry)],
                self._env_gen.get_state(), self._act_gen.get_state())

    def _restore(self, saved):
        leaves, env_gen, act_gen = saved
        for dst, src in zip(_tensors(self._carry), leaves):
            dst.copy_(src)
        self._env_gen.set_state(env_gen)
        self._act_gen.set_state(act_gen)

    # ------------------------------------------------------------ the unroll

    @torch.no_grad()
    def _unroll(self, params):
        """T steps of policy and env from the carry, into the trajectory
        buffer; the new carry is written back in place. What the graph
        holds on a CUDA device, and what runs eagerly on the CPU."""
        env_state, core, obs = self._carry
        out = self._views
        for t in range(self.unroll):
            if self.with_logprobs:
                actions, logprobs, core = self._policy(params, core, obs, self._act_gen)
                out["behavior_logprobs"][t].copy_(logprobs)
            else:
                actions, core = self._policy(params, core, obs, self._act_gen)
            out["obs"][t].copy_(obs)
            out["actions"][t].copy_(actions)
            env_state, obs, rewards, dones = self.env.step(
                env_state, actions.to(torch.int64), self._env_gen)
            out["rewards"][t].copy_(rewards)
            out["dones"][t].copy_(dones)
        self._write_carry((env_state, core, obs))

    def _capture(self, params):
        """Capture `_unroll` as a CUDA graph on a side stream of its own,
        after eager unrolls there; the caller restores the carry and the
        generators those advanced. ``thread_local`` capture: other threads
        (the learner) may launch work meanwhile."""
        self._params = _map(lambda x: x.detach().to(self.device, copy=True), params)
        graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK, torch.cuda.device(self.device):
            stream = torch.cuda.Stream(self.device)
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                for _ in range(WARMUP_UNROLLS):
                    self._unroll(self._params)
                graph.register_generator_state(self._env_gen)
                graph.register_generator_state(self._act_gen)
                # a CUDA graph destroyed while this one captures (an engine
                # the collector frees) invalidates the capture: collect
                # first, and nothing until the capture ends
                gc.collect()
                gc_enabled = gc.isenabled()
                gc.disable()
                try:
                    graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        self._unroll(self._params)
                    except BaseException:
                        # leave the stream out of capture mode, then raise the cause
                        with contextlib.suppress(RuntimeError):
                            graph.capture_end()
                        raise
                    graph.capture_end()
                finally:
                    if gc_enabled:
                        gc.enable()
            torch.cuda.current_stream(self.device).wait_stream(stream)
        self._graph = graph
        self.captures += 1

    def _ensure_captured(self, params):
        signature = _signature(params)
        if self._graph is not None and signature == self._signature:
            return
        saved = self._snapshot()
        try:
            self._capture(params)
        finally:
            self._restore(saved)
        self._signature = signature

    def warmup(self, params):
        """Capture the unroll (on the CPU: run it once) without advancing
        lane state, generators or counters."""
        if self._carry is None:
            self.reset()
        if self.device.type == "cuda":
            self._ensure_captured(params)
            return
        saved = self._snapshot()
        try:
            self._unroll(params)
        finally:
            self._restore(saved)

    def dispatch(self, params) -> torch.Tensor:
        """Launch one unroll asynchronously: advances the carry and the
        counters, returns the packed trajectory ON THE DEVICE (no host
        transfer yet; `to_host` unpacks it). `ShardedRolloutEngine` uses
        this to get all K engines' unrolls in flight before the first copy
        back. The buffer is overwritten by the next dispatch."""
        if self._carry is None:
            self.reset()
        if self.device.type == "cuda":
            self._ensure_captured(params)
            with torch.no_grad():
                for dst, src in zip(_tensors(self._params), _tensors(params)):
                    dst.copy_(src)
            self._graph.replay()
        else:
            self._unroll(params)
        self.scans += 1
        self.frames += self.unroll * self.num_envs
        return self._flat

    def to_host(self, flat: torch.Tensor) -> dict:
        """ONE copy of a packed trajectory to the host, unpacked into numpy
        views of that copy."""
        host = flat.to("cpu", copy=True).numpy()
        return {name: host[o:o + n].view(torch.empty((), dtype=dtype).numpy().dtype)
                .reshape(shape) for name, shape, dtype, o, n in self._fields}

    def rollout(self, params) -> dict:
        """Advance all lanes T steps in one device call; ONE host transfer."""
        return self.to_host(self.dispatch(params))


class ShardedRolloutEngine:
    """K `DeviceRolloutEngine`s presenting as one engine.

    Lanes are partitioned contiguously into K shards; shard k's engine is
    placed on ``devices[k % len(devices)]`` (by default every CUDA device
    round-robin, so on one card all K share it; an env on the CPU keeps
    the CPU). One `rollout()` dispatches ALL K unrolls before the first
    copy back; frame and scan accounting is summed across engines, and the
    trajectory comes back as one (T, E_total, ...) batch, so
    `RolloutWorker` and the replay schema are unchanged.

    Seeding: shard k of an engine seeded `s` uses ``s * K + k`` — distinct
    per shard, and disjoint across workers as long as every worker uses
    the same K (which `SeedSystem` does).
    """

    def __init__(self, env, policy_apply: Callable, num_envs: int,
                 unroll: int, *, num_shards: int,
                 init_core: Optional[Callable] = None, seed: int = 0,
                 devices=None, with_logprobs: bool = False):
        if not isinstance(num_shards, int) or num_shards < 1:
            raise ValueError(
                f"num_shards must be a positive int, got {num_shards!r}")
        if num_shards > num_envs:
            raise ValueError(
                f"num_shards={num_shards} exceeds num_envs={num_envs}: "
                f"each engine shard needs at least one lane")
        if devices is None:
            home = as_torch_env(env).device
            devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                       if home.type == "cuda" else [home])
        devices = list(devices)
        if not devices:
            raise ValueError("no devices available to place engine shards")
        self.num_envs = num_envs
        self.unroll = unroll
        self.num_shards = num_shards
        base, extra = divmod(num_envs, num_shards)
        self.engines = []
        for k in range(num_shards):
            lanes = base + (1 if k < extra else 0)
            self.engines.append(DeviceRolloutEngine(
                env, policy_apply, lanes, unroll, init_core=init_core,
                seed=seed * num_shards + k,
                device=devices[k % len(devices)],
                with_logprobs=with_logprobs))
        self.num_actions = self.engines[0].num_actions
        self.obs_shape = self.engines[0].obs_shape
        self.devices = [e.device for e in self.engines]
        self.scans = 0                    # sharded rollouts driven

    @property
    def frames(self) -> int:
        """Env frames supplied, summed across engine shards."""
        return sum(e.frames for e in self.engines)

    @property
    def shard_scans(self) -> int:
        """Per-engine scan total (= scans * num_shards once started)."""
        return sum(e.scans for e in self.engines)

    @property
    def captures(self) -> int:
        return sum(e.captures for e in self.engines)

    def reset(self) -> np.ndarray:
        return np.concatenate([e.reset() for e in self.engines])

    def warmup(self, params):
        for e in self.engines:
            e.warmup(params)

    def rollout(self, params) -> dict:
        """Advance all lanes T steps: K device calls dispatched before any
        host transfer, then ONE copy per shard, concatenated on the lane
        axis into the (T, E_total, ...) unroll schema."""
        flats = [e.dispatch(params) for e in self.engines]
        hosts = [e.to_host(f) for e, f in zip(self.engines, flats)]
        self.scans += 1
        return {k: np.concatenate([h[k] for h in hosts], axis=1) for k in hosts[0]}
