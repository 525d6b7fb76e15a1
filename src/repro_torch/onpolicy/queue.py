"""Staleness-aware bounded trajectory queue — the on-policy replay analogue.

A copy of ``repro.onpolicy.queue`` (numpy and threading): the port keeps
its own so that it imports nothing of the JAX package.

Replay-based R2D2 tolerates arbitrarily old data, so `PrioritizedReplay`
never says no. On-policy V-trace does not: its importance weights correct
*slight* staleness (a few learner steps of lag), and GA3C showed that once
queue depth grows the actor-side policy lag dominates everything else in
the CPU/GPU balance. `TrajectoryQueue` is therefore a bounded queue with
an admission policy instead of a ring buffer:

  * every per-lane unroll arrives stamped with the behavior-param
    ``param_version`` it was generated under (the actors stamp it — see
    `core.actor.Actor`);
  * an unroll whose lag ``current_version - param_version`` exceeds
    ``max_param_lag`` is DROPPED and counted, at admission and again at
    pop (data ages while it queues);
  * when the queue is full the OLDEST unroll is evicted (on-policy wants
    the freshest data; dropping the newcomer would invert that);
  * `close()` drains whatever is pending into the dropped count, so the
    frame ledger stays conserved through shutdown.

Frame accounting is the contract the system tests pin down:

    frames_generated == frames_trained + frames_dropped + frames_pending

with ``frames_pending == 0`` after `close()`. Every counter is kept under
one lock, so the invariant holds at any observation point, not just at
rest. The queue reports the mean lag of the unrolls it
actually handed to the learner (`mean_trained_lag`), which is the
staleness the V-trace correction actually sees.
"""

import threading
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np


class Closed(Exception):
    """The queue was closed; no further batches will ever be available."""


def _unroll_frames(traj: Dict[str, np.ndarray]) -> int:
    return int(np.asarray(traj["rewards"]).shape[0])


def _unroll_version(traj: Dict[str, np.ndarray]) -> Optional[int]:
    v = traj.get("param_version")
    return None if v is None else int(np.asarray(v).reshape(()))


class TrajectoryQueue:
    """Bounded FIFO of per-lane unrolls with staleness-aware admission.

    ``version_source() -> int`` is the learner's current published param
    version (`SeedSystem._version`); ``max_param_lag=None`` disables the
    staleness drop (the queue is then just bounded). ``capacity`` is in
    UNROLLS, matching the learner-batch unit.
    """

    def __init__(self, capacity: int, max_param_lag: Optional[int] = None,
                 version_source: Optional[Callable[[], int]] = None,
                 metrics=None, health=None):
        if not isinstance(capacity, int) or capacity < 1:
            raise ValueError(
                f"capacity must be a positive int (unrolls), got {capacity!r}")
        if max_param_lag is not None and max_param_lag < 0:
            raise ValueError(
                f"max_param_lag must be >= 0 or None, got {max_param_lag!r}")
        self.capacity = capacity
        self.max_param_lag = max_param_lag
        self._version_source = version_source
        self._cond = threading.Condition()
        self._q: "deque" = deque()           # (traj, frames, version|None)
        self._closed = False
        # frame ledger — every mutation holds _cond's lock
        self.frames_generated = 0
        self.frames_trained = 0
        self.frames_dropped_stale = 0
        self.frames_dropped_overflow = 0
        self.frames_dropped_shutdown = 0
        self.frames_dropped_fault = 0
        self.frames_pending = 0
        self.unrolls_trained = 0
        self.trained_lag_sum = 0
        # optional HeartbeatRegistry: admissions stamp liveness so the
        # ops plane can see the trajectory plane moving. Informational
        # deadline (None): an idle-but-healthy system admits nothing.
        self._health = health
        if health is not None:
            health.register("onpolicy/queue", stale_after_s=None)
        if metrics is not None:
            # callback gauges: the registry reads these plain-int attributes
            # at snapshot time, so the queue's hot path pays nothing. The
            # reads are lock-free (GIL-atomic int loads) and each value is
            # individually consistent — exact cross-field invariants come
            # from `stats()`, which holds the queue lock.
            metrics.gauge("onpolicy/queue_depth", fn=lambda: len(self._q))
            metrics.gauge("onpolicy/frames_pending",
                          fn=lambda: self.frames_pending)
            metrics.gauge("onpolicy/drop_rate",
                          fn=lambda: self.frames_dropped
                          / max(self.frames_generated, 1))
            metrics.gauge("onpolicy/mean_trained_lag",
                          fn=lambda: self.trained_lag_sum
                          / max(self.unrolls_trained, 1))

    # ------------------------------------------------------------ internals

    def _version(self) -> int:
        return self._version_source() if self._version_source else 0

    def _lag(self, version: Optional[int], now: int) -> int:
        """Lag of an unroll stamped `version` against the current param
        version; unstamped unrolls are treated as fresh (lag 0), and a
        stamp from the future (clock skew across processes) clips to 0."""
        return 0 if version is None else max(now - version, 0)

    # -------------------------------------------------------------- produce

    def put(self, traj: Dict[str, np.ndarray]):
        """Admit one per-lane unroll (the `flush_lane_unrolls` schema,
        plus optional ``param_version`` / ``behavior_logprobs`` fields).
        Never blocks and never raises: over-full and over-stale unrolls
        are counted drops — backpressure on actors would stall the env
        plane, which is the resource the paper says to protect."""
        frames = _unroll_frames(traj)
        version = _unroll_version(traj)
        if self._health is not None:
            self._health.beat("onpolicy/queue")
        with self._cond:
            self.frames_generated += frames
            if self._closed:
                self.frames_dropped_shutdown += frames
                return
            now = self._version()
            if (self.max_param_lag is not None
                    and self._lag(version, now) > self.max_param_lag):
                self.frames_dropped_stale += frames
                return
            self._q.append((traj, frames, version))
            self.frames_pending += frames
            while len(self._q) > self.capacity:
                _, f, _ = self._q.popleft()      # evict OLDEST: keep fresh
                self.frames_pending -= f
                self.frames_dropped_overflow += f
            self._cond.notify_all()

    # -------------------------------------------------------------- consume

    def pop_batch(self, n: int, timeout: Optional[float] = None
                  ) -> List[Dict[str, np.ndarray]]:
        """Block until n unrolls are available, then pop them atomically
        (all-or-nothing, so the frame ledger never counts a half-assembled
        batch as trained). Unrolls that went stale while queued are
        dropped here, not handed over. Raises `Closed` once the queue is
        closed (and TimeoutError on `timeout`, for polling callers)."""
        if n < 1:
            raise ValueError(f"batch size must be >= 1, got {n}")
        with self._cond:
            while True:
                now = self._version()
                if self.max_param_lag is not None:
                    while self._q and self._lag(self._q[0][2], now) \
                            > self.max_param_lag:
                        _, f, _ = self._q.popleft()
                        self.frames_pending -= f
                        self.frames_dropped_stale += f
                if len(self._q) >= n:
                    out = []
                    for _ in range(n):
                        traj, f, version = self._q.popleft()
                        self.frames_pending -= f
                        self.frames_trained += f
                        self.unrolls_trained += 1
                        self.trained_lag_sum += self._lag(version, now)
                        out.append(traj)
                    return out
                if self._closed:
                    raise Closed("trajectory queue closed")
                if not self._cond.wait(timeout=timeout):
                    raise TimeoutError(
                        f"no batch of {n} unrolls within {timeout}s")

    def close(self):
        """Stop admitting, drain pending into the dropped count, and wake
        every blocked `pop_batch`. Idempotent."""
        with self._cond:
            if not self._closed:
                self._closed = True
                while self._q:
                    _, f, _ = self._q.popleft()
                    self.frames_pending -= f
                    self.frames_dropped_shutdown += f
            self._cond.notify_all()

    def reopen(self):
        """Undo `close()` so a resumed run can admit again — the
        `SeedSystem.resume()` path. The ledger carries over: counters are
        cumulative across the crash boundary, which is exactly what makes
        conservation a cross-restart oracle. Idempotent."""
        with self._cond:
            self._closed = False

    def drop_pending(self) -> int:
        """Fault path (a producer died mid-run): drain every queued unroll
        into the FAULT drop count so frames from the dead incarnation are
        never handed to the learner as trained data. Conservation holds
        across the call — pending moves to dropped under the one lock.
        Returns the number of frames dropped."""
        with self._cond:
            dropped = 0
            while self._q:
                _, f, _ = self._q.popleft()
                self.frames_pending -= f
                dropped += f
            self.frames_dropped_fault += dropped
            return dropped

    # ---------------------------------------------------------------- stats

    def __len__(self):
        with self._cond:
            return len(self._q)

    @property
    def frames_dropped(self) -> int:
        return (self.frames_dropped_stale + self.frames_dropped_overflow
                + self.frames_dropped_shutdown + self.frames_dropped_fault)

    def stats(self) -> dict:
        """One consistent snapshot of the frame ledger (see module doc:
        generated == trained + dropped + pending always holds here)."""
        with self._cond:
            return {
                "frames_generated": self.frames_generated,
                "frames_trained": self.frames_trained,
                "frames_dropped": self.frames_dropped,
                "frames_dropped_stale": self.frames_dropped_stale,
                "frames_dropped_overflow": self.frames_dropped_overflow,
                "frames_dropped_shutdown": self.frames_dropped_shutdown,
                "frames_dropped_fault": self.frames_dropped_fault,
                "frames_pending": self.frames_pending,
                "drop_rate": self.frames_dropped
                / max(self.frames_generated, 1),
                "unrolls_trained": self.unrolls_trained,
                "mean_trained_lag": self.trained_lag_sum
                / max(self.unrolls_trained, 1),
                "max_param_lag": self.max_param_lag,
                "capacity": self.capacity,
            }
