"""V-trace learner: the on-policy train_step and the sampling policies
that generate its data.

Mirrors ``repro.onpolicy.learner`` in PyTorch. `make_vtrace_train_step`
builds the ``train_step(state, batch)`` the generic `core.learner.Learner`
loop drives — the same publish/version seam R2D2 uses, different math:
V-trace corrected targets (`core.vtrace`) over the staleness-stamped
batches a `VTraceBatcher` assembles. The last unroll step is the
bootstrap anchor (its value estimate closes the return), so a T-step
unroll trains T-1 positions.

Params are a flat dict ``{w1, b1, wp, bp, wv, bv}`` of tensors (the
reference's leaf names), the layout the port's AdamW updates in place.
Because that update is in place where JAX arrays are immutable, the
sampling policy never aliases the learner's tensors: it keeps its own
copy, which `SamplingPolicy.publish` overwrites under the lock that each
sample holds while it launches its forward, so a batch of behavior
logprobs comes from one version of the params.

Data generation needs the policy to report the behavior logprob of every
sampled action (V-trace's denominator). Two adapters:

  * `SamplingPolicy` — a host-side ``policy_step`` for the central
    `InferenceServer`: samples on the params' device from an explicit
    ``torch.Generator`` and returns the ``(N, 2) float32 [action,
    logprob]`` convention on-policy actors decode
    (`core.actor.Actor(with_logprobs=True)`);
  * `make_device_sampling_policy` — the pure ``policy_apply(params, core,
    obs, gen) -> (actions, logprobs, core)`` of the device backend.
"""

import copy
import threading
from typing import Callable, Tuple

import numpy as np
import torch

from repro_torch.core.losses import param_grads
from repro_torch.core.vtrace import vtrace, vtrace_losses
from repro_torch.device import resolve
from repro_torch.optim.adamw import apply_updates


def mlp_actor_critic(obs_dim: int, num_actions: int, hidden: int = 64):
    """Tiny shared-torso actor-critic: returns (init_fn, apply_fn) with
    ``apply_fn(params, obs[..., obs_dim]) -> (logits[..., A], value[...])``
    — rank-polymorphic, so the same function serves (N,) inference
    batches and (B, T) learner batches.

    ``init_fn(gen, device="cuda")`` draws the weights on the CPU from the
    ``torch.Generator`` `gen` (so a seed gives the same params on every
    device) and returns them on `device`, trainable."""

    def init_fn(gen: torch.Generator, device="cuda"):
        dev = resolve(device)
        s = 1.0 / np.sqrt(obs_dim)
        params = {
            "w1": torch.randn((obs_dim, hidden), generator=gen) * s,
            "b1": torch.zeros((hidden,)),
            "wp": torch.randn((hidden, num_actions), generator=gen) * 0.01,
            "bp": torch.zeros((num_actions,)),
            "wv": torch.randn((hidden, 1), generator=gen) * 0.01,
            "bv": torch.zeros((1,)),
        }
        return {k: v.to(dev).requires_grad_(True) for k, v in params.items()}

    def apply_fn(params, obs):
        h = torch.relu(obs @ params["w1"] + params["b1"])
        logits = h @ params["wp"] + params["bp"]
        value = (h @ params["wv"] + params["bv"])[..., 0]
        return logits, value

    return init_fn, apply_fn


def device_batch(batch, device) -> dict:
    """An `assemble_vtrace_batch` batch (numpy) on `device`: obs, rewards,
    discounts and behavior logprobs as fp32, actions as int64 for the
    gather. ``param_version`` stays on the host."""

    def put(name, dtype):
        return torch.as_tensor(np.asarray(batch[name]), dtype=dtype).to(device)

    out = {"obs": put("obs", torch.float32), "actions": put("actions", torch.int64)}
    for name in ("rewards", "discounts", "behavior_logprobs"):
        out[name] = put(name, torch.float32)
    return out


def make_vtrace_train_step(apply_fn: Callable, optimizer, *,
                           rho_bar: float = 1.0, c_bar: float = 1.0,
                           value_coef: float = 0.5,
                           entropy_coef: float = 0.01):
    """train_step(state, batch) -> (state, metrics) over V-trace batches.

    ``apply_fn(params, obs[B, T, ...]) -> (logits[B, T, A], values[B, T])``;
    batch fields are the `assemble_vtrace_batch` schema, moved to the
    params' device here. The state is ``{params, opt_state, step}`` (step a
    Python int), updated in place through the optimizer and
    `apply_updates`; the metrics are 0-d device tensors."""

    def loss_fn(params, batch):
        logits, values = apply_fn(params, batch["obs"])
        logp = torch.log_softmax(logits, dim=-1)
        taken = torch.gather(logp, -1, batch["actions"][..., None])[..., 0]
        entropy = -torch.sum(torch.softmax(logits, dim=-1) * logp, dim=-1)

        # step T-1 only bootstraps: train positions 0..T-2
        tlp = taken[:, :-1]
        vtr = vtrace(tlp, batch["behavior_logprobs"][:, :-1],
                     batch["rewards"][:, :-1], batch["discounts"][:, :-1],
                     values[:, :-1], values[:, -1],
                     rho_bar=rho_bar, c_bar=c_bar)
        mask = torch.ones_like(tlp)
        pg, vl, en = vtrace_losses(tlp, entropy[:, :-1], vtr, values[:, :-1],
                                   mask, value_coef=value_coef,
                                   entropy_coef=entropy_coef)
        loss = pg + vl + en
        return loss, {"loss": loss.detach(), "pg_loss": pg.detach(),
                      "value_loss": vl.detach(), "entropy_loss": en.detach(),
                      "mean_rho": vtr.rhos.detach().mean()}

    def train_step(state, batch):
        params = state["params"]
        device = next(iter(params.values())).device
        loss, metrics = loss_fn(params, device_batch(batch, device))
        grads = param_grads(loss, params)
        del loss
        updates, opt_state, om = optimizer.update(
            grads, state["opt_state"], params, state["step"])
        apply_updates(params, updates)
        metrics.update(om)
        return {"params": params, "opt_state": opt_state,
                "step": state["step"] + 1}, metrics

    return train_step


class VTraceLearner:
    """The on-policy learner bundle for one (logits, value) policy: the
    V-trace `train_step` (what `SeedSystem(algo="vtrace")` drives through
    the generic `Learner` loop), fresh train state, the two sampling
    adapters, and a warmup that runs the step once at the system's batch
    shape (cuBLAS handles, the caching allocator) before a measured
    window."""

    def __init__(self, apply_fn: Callable, optimizer, *,
                 rho_bar: float = 1.0, c_bar: float = 1.0,
                 value_coef: float = 0.5, entropy_coef: float = 0.01):
        self.apply_fn = apply_fn
        self.optimizer = optimizer
        self.train_step = make_vtrace_train_step(
            apply_fn, optimizer, rho_bar=rho_bar, c_bar=c_bar,
            value_coef=value_coef, entropy_coef=entropy_coef)

    def init_state(self, params) -> dict:
        """Standard {params, opt_state, step} train state."""
        return {"params": params, "opt_state": self.optimizer.init(params),
                "step": 0}

    def warmup(self, state, *, batch_size: int, unroll: int,
               obs_shape: Tuple[int, ...], obs_dtype=np.float32):
        """Run the train step on a structurally-identical dummy batch. The
        step works in place, so it runs on a deep copy: `state` is NOT
        advanced."""
        from repro_torch.onpolicy.batcher import assemble_vtrace_batch
        dummy = [{"obs": np.zeros((unroll,) + tuple(obs_shape), obs_dtype),
                  "actions": np.zeros((unroll,), np.int32),
                  "rewards": np.zeros((unroll,), np.float32),
                  "dones": np.zeros((unroll,), np.float32),
                  "behavior_logprobs": np.zeros((unroll,), np.float32)}
                 ] * batch_size
        self.train_step(copy.deepcopy(state),
                        assemble_vtrace_batch(dummy, gamma=0.99))

    def sampling_policy(self, params, seed: int = 0) -> "SamplingPolicy":
        """Host-backend `policy_step` on the params' device (wire
        `.publish` via `SeedSystem(policy_publish=...)`)."""
        device = next(iter(params.values())).device
        return SamplingPolicy(self.apply_fn, params, seed=seed, device=device)

    def device_policy_apply(self) -> Callable:
        """Device-backend `policy_apply`."""
        return make_device_sampling_policy(self.apply_fn)


def _sample_with_logprobs(apply_fn):
    def fn(params, obs, gen):
        logits, _ = apply_fn(params, obs)
        # Gumbel-max, as jax.random.categorical samples
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
        actions = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
        lp = torch.gather(torch.log_softmax(logits, dim=-1), -1,
                          actions[..., None])[..., 0]
        return actions, lp
    return fn


class SamplingPolicy:
    """Host-backend ``policy_step`` that reports behavior logprobs.

    Returns ``(N, 2) float32`` rows of [action, behavior_logprob] — the
    reply convention `Actor(with_logprobs=True)` decodes — sampled on
    `device` from one generator seeded with `seed`. The policy keeps its
    own copy of the params; `publish` overwrites it under a lock that a
    sample holds while it draws and launches its forward (inference
    replicas may call concurrently with the learner's publish), so the
    caller's tensors may change in place afterwards. `version` mirrors the
    publish step.
    """

    def __init__(self, apply_fn: Callable, params, seed: int = 0,
                 device="cuda"):
        self.device = resolve(device)
        self._sample = _sample_with_logprobs(apply_fn)
        self._lock = threading.Lock()
        self._params = {k: v.detach().to(self.device, copy=True)
                        for k, v in params.items()}
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.version = 0

    @torch.no_grad()
    def publish(self, params, step: int):
        with self._lock:
            for k, dst in self._params.items():
                dst.copy_(params[k])
            self.version = int(step)

    @torch.no_grad()
    def __call__(self, obs: np.ndarray, slot_ids) -> np.ndarray:
        obs_t = torch.as_tensor(np.asarray(obs), dtype=torch.float32).to(self.device)
        with self._lock:
            actions, lp = self._sample(self._params, obs_t, self._gen)
            out = torch.stack([actions.to(torch.float32), lp], dim=1)
        return out.cpu().numpy()


def make_device_sampling_policy(apply_fn: Callable):
    """Device-backend counterpart of `SamplingPolicy`: a pure
    ``policy_apply(params, core, obs, gen) -> (actions, logprobs, core)``,
    drawing from the ``torch.Generator`` `gen` on the params' device."""
    sample = _sample_with_logprobs(apply_fn)

    def policy_apply(params, core, obs, gen):
        with torch.no_grad():
            actions, lp = sample(params, obs, gen)
        return actions, lp, core

    return policy_apply
