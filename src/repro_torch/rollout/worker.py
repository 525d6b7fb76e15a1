"""RolloutWorker: the thread that drives repeated fused unrolls.

A copy of ``repro.rollout.worker`` with its imports taken from the port.
It plays the role `core.actor.Actor` plays for the host backends — same
counters (`iterations`, `frames`, `episodes`, `returns`), same per-lane
unroll format into the trajectory sink — but each iteration is ONE device
unroll (a CUDA graph replay on the card) of T steps x E lanes instead of
T inference round-trips. Between unrolls it refreshes params from the
learner (`param_source`) and tracks the on-policy lag: how many learner
steps elapsed since the params used for the previous unroll were
published.
"""

import threading
import traceback
from typing import Callable, Optional

import numpy as np

from repro_torch.core.actor import account_episode_ends, flush_lane_unrolls


class RolloutWorker:
    def __init__(self, worker_id: int, engine, sink: Callable,
                 param_source: Callable, stamp_records: bool = False,
                 health=None):
        """param_source() -> (params, version): latest published params and
        a monotone version counter (learner steps; 0 before any publish);
        the params must not change after they are handed out (`SeedSystem`
        publishes a snapshot).
        ``stamp_records=True`` writes the behavior ``param_version`` into
        every flushed lane record — the on-policy queue's admission key
        (replay records stay byte-identical without it)."""
        self.worker_id = worker_id
        self.engine = engine
        self.sink = sink
        self.param_source = param_source
        self.stamp_records = stamp_records
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.episodes = 0
        self.episode_returns = np.zeros(engine.num_envs, np.float64)
        self.returns = []
        self.param_version = 0            # version driving the current unroll
        self.param_refreshes = 0          # unrolls that picked up fresh params
        self.param_lag_total = 0          # sum of version deltas across unrolls
        self.error: Optional[str] = None
        self._health = health             # optional HeartbeatRegistry

    # the engine is the single source of truth for scan/frame counts
    @property
    def iterations(self):
        """Unrolls driven (one device round trip each)."""
        return self.engine.scans

    @property
    def frames(self):
        """Env frames supplied = scans * T * E."""
        return self.engine.frames

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()

    def join(self, timeout=5.0):
        if self._thread:
            self._thread.join(timeout=timeout)

    def warmup(self):
        """Capture the unroll up front so the measured window is steady-state."""
        params, _ = self.param_source()
        self.engine.warmup(params)

    def _loop(self):
        # record fatal errors instead of dying silently (same class as
        # Learner.error / InferenceServer.error)
        hb = self._health
        hb_name = f"rollout/worker{self.worker_id}"
        if hb is not None:
            # one beat per unroll; 10 s tolerates a first capture that
            # slipped past warmup() while still catching a wedge
            hb.register(hb_name, stale_after_s=10.0)
        try:
            self._run()
        except Exception:
            self.error = traceback.format_exc()
            self._stop.set()
        finally:
            if hb is not None:
                hb.unregister(hb_name)

    def _run(self):
        T = self.engine.unroll
        hb = self._health
        hb_name = f"rollout/worker{self.worker_id}"
        while not self._stop.is_set():
            if hb is not None:
                hb.beat(hb_name)
            params, version = self.param_source()
            if version != self.param_version:
                self.param_lag_total += version - self.param_version
                self.param_refreshes += 1
                self.param_version = version
            traj = self.engine.rollout(params)          # (T, E, ...)
            rewards, dones = traj["rewards"], traj["dones"].astype(bool)
            for t in range(T):
                self.episodes += account_episode_ends(
                    rewards[t], dones[t], self.episode_returns, self.returns)
            extra = ({"param_version": np.int64(self.param_version)}
                     if self.stamp_records else None)
            flush_lane_unrolls(traj, self.sink, extra=extra)
