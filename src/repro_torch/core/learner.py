"""Learner loop: sample -> train_step -> publish params.

The learner is the accelerator-resident half of SEED: it consumes
trajectory batches (prioritized replay for R2D2, on-policy queue for
V-trace), runs the train_step, and publishes fresh params
to the inference server under a version counter. Periodic checkpointing
and restart-on-failure live here (see repro_torch.checkpoint).

A copy of ``repro.core.learner`` without JAX. Where the reference waits
with ``jax.block_until_ready`` on the new step, the port synchronises the
device that the train state's params live on, so ``train_time_s`` holds
the step's device time and not only its launches: the learner-bound
attribution (train against wait seconds) rests on it. Metrics come to the
host with ``.cpu()``."""

import queue
import threading
import time
import traceback
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def sync_state(state):
    """Wait for the device work queued on the train state's params (a
    module or a dict of tensors under ``state["params"]``); a no-op on the
    CPU, where the step ran as it was called."""
    params = state.get("params") if isinstance(state, dict) else None
    if isinstance(params, torch.nn.Module):
        params = next(params.parameters(), None)
    elif isinstance(params, dict):
        params = next(iter(params.values()), None)
    if isinstance(params, torch.Tensor) and params.is_cuda:
        torch.cuda.synchronize(params.device)


class BatchSourceClosed(Exception):
    """Raised by a batch_fn whose source was poisoned by `Learner.stop()`
    (e.g. a closed on-policy trajectory queue); `_loop` treats it as a
    clean shutdown, not an error."""


class Learner:
    def __init__(self, train_step: Callable, state, batch_fn: Callable,
                 publish: Optional[Callable] = None,
                 checkpoint_manager=None, checkpoint_every: int = 0,
                 checkpoint_every_s: float = 0.0,
                 priority_update: Optional[Callable] = None,
                 poison: Optional[Callable] = None,
                 telemetry=None):
        """batch_fn() -> (batch, info) blocking; publish(params, step).

        ``poison()`` is called from `stop()` to unblock a batch_fn that is
        waiting on an empty source (the batch_fn should then raise
        `BatchSourceClosed`); without it a blocking source would hang the
        learner thread past `join`'s timeout forever. Polling batch_fns
        can instead watch `stopped` and raise `BatchSourceClosed`
        themselves.
        """
        self.train_step = train_step
        self.state = state
        self.batch_fn = batch_fn
        self.publish = publish
        self.ckpt = checkpoint_manager
        self.checkpoint_every = checkpoint_every
        # wall-clock checkpoint cadence (0 disables): the live-loop fault
        # tolerance knob — step-based cadence stalls when steps stall,
        # which is exactly when a crash costs the most un-checkpointed work
        self.checkpoint_every_s = checkpoint_every_s
        self._last_ckpt_t = time.perf_counter()
        self.priority_update = priority_update
        self.poison = poison
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.steps = 0
        self.metrics: Dict[str, float] = {}
        self.train_time_s = 0.0
        self.wait_time_s = 0.0
        self.error: Optional[str] = None     # traceback of a fatal loop error
        # timings are already taken in _one_step; telemetry just adds the
        # distribution (p50/p95/p99) view and an optional per-step span
        self._tracer = (telemetry.tracer
                        if telemetry is not None and telemetry.enabled
                        else None)
        if telemetry is not None:
            self._h_train = telemetry.metrics.histogram("learner/train_s")
            self._h_wait = telemetry.metrics.histogram("learner/wait_s")
        else:
            self._h_train = None
            self._h_wait = None
        self._health = getattr(telemetry, "health", None)

    @property
    def stopped(self) -> bool:
        """True once stop() was called (or the loop died); batch_fns that
        poll-and-sleep must check this so stop() can interrupt the wait."""
        return self._stop.is_set()

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self.poison is not None:
            self.poison()

    def join(self, timeout=30.0):
        if self._thread:
            self._thread.join(timeout=timeout)

    def run_steps(self, n: int):
        for _ in range(n):
            self._one_step()

    def _one_step(self):
        t0 = time.perf_counter()
        batch, info = self.batch_fn()
        t1 = time.perf_counter()
        self.state, metrics = self.train_step(self.state, batch)
        sync_state(self.state)
        t2 = time.perf_counter()
        self.wait_time_s += t1 - t0
        self.train_time_s += t2 - t1
        self.steps += 1
        if self._h_train is not None:
            self._h_wait.record(t1 - t0)
            self._h_train.record(t2 - t1)
        if self._tracer is not None:
            now_ns = time.perf_counter_ns()
            self._tracer.record("learner/train_step",
                                now_ns - int((t2 - t1) * 1e9),
                                int((t2 - t1) * 1e9),
                                args={"step": self.steps})
        metrics = {k: _host(v) for k, v in metrics.items()}
        self.metrics = {k: float(v.mean()) for k, v in metrics.items() if v.ndim == 0}
        if self.priority_update and "priorities" in metrics:
            self.priority_update(info, metrics["priorities"])
        if self.publish:
            self.publish(self.state["params"], self.steps)
        if self.ckpt and self.checkpoint_every and \
                self.steps % self.checkpoint_every == 0:
            self.ckpt.save(self.state, self.steps)
        elif self.ckpt and self.checkpoint_every_s and \
                time.perf_counter() - self._last_ckpt_t \
                >= self.checkpoint_every_s:
            # async: hands off a host snapshot and keeps training — the
            # save must not stall the accelerator (see CheckpointManager)
            self.ckpt.save(self.state, self.steps)
            self._last_ckpt_t = time.perf_counter()

    def _loop(self):
        # A bare `except queue.Empty` would let any other exception kill the
        # thread silently; record it so the system can surface the death.
        hb = self._health
        if hb is not None:
            # generous deadline: the first train_step pays cuBLAS/cuDNN
            # set-up (seconds), and an empty trajectory queue legitimately
            # blocks batch_fn — only a truly wedged learner should flag
            hb.register("learner", stale_after_s=30.0)
        try:
            while not self._stop.is_set():
                if hb is not None:
                    hb.beat("learner")
                try:
                    self._one_step()
                except queue.Empty:
                    continue
                except BatchSourceClosed:
                    break             # poisoned batch source: clean shutdown
                except Exception:
                    self.error = traceback.format_exc()
                    self._stop.set()
                    break
        finally:
            if hb is not None:
                hb.unregister("learner")
