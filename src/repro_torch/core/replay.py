"""Prioritized sequence replay buffer (R2D2-style), host-side.

A copy of ``repro.core.replay`` (numpy only): the port keeps its own so
that it imports nothing of the JAX package. With the same seed and the
same adds it samples the same indices and weights.

Numpy ring buffer storing fixed-length sequences; proportional
prioritization p_i^alpha with importance-sampling weights. Thread-safe:
actors add() while the learner sample()s — the paper's replay-management
task, which competes with actors for the same host CPU threads.
"""

import threading
from typing import Dict

import numpy as np


class PrioritizedReplay:
    def __init__(self, capacity: int, alpha: float = 0.9, seed: int = 0):
        self.capacity = capacity
        self.alpha = alpha
        self._storage: Dict[str, np.ndarray] = {}
        self._priorities = np.zeros((capacity,), np.float64)
        self._next = 0
        self._size = 0
        self._lock = threading.Lock()
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return self._size

    def add(self, seq: Dict[str, np.ndarray], priority: float):
        with self._lock:
            i = self._next
            if not self._storage:
                for k, v in seq.items():
                    v = np.asarray(v)
                    self._storage[k] = np.zeros((self.capacity,) + v.shape, v.dtype)
            for k, v in seq.items():
                self._storage[k][i] = v
            self._priorities[i] = max(float(priority), 1e-6) ** self.alpha
            self._next = (i + 1) % self.capacity
            self._size = min(self._size + 1, self.capacity)

    def sample(self, batch: int, beta: float = 0.6):
        with self._lock:
            n = self._size
            assert n > 0, "empty replay"
            p = self._priorities[:n]
            probs = p / p.sum()
            idx = self._rng.choice(n, size=batch, p=probs)
            w = (n * probs[idx]) ** (-beta)
            w = w / w.max()
            out = {k: v[idx].copy() for k, v in self._storage.items()}
            return out, idx, w.astype(np.float32)

    def update_priorities(self, idx: np.ndarray, priorities: np.ndarray):
        with self._lock:
            self._priorities[idx] = np.maximum(priorities, 1e-6) ** self.alpha
