"""Bounded exponential backoff with deterministic jitter.

A copy of ``repro.fault.backoff`` (standard library only).

One schedule object shared by every reconnect path (socket transport,
shm transport, gateway failover) so retry behaviour is a single policy,
testable by itself: delays never exceed `cap_s`, the schedule yields
exactly `max_retries` delays before giving up, and a fixed `seed` makes
the jitter reproducible (chaos tests replay identical schedules).
"""

import random
from dataclasses import dataclass
from typing import Iterator, Optional


@dataclass(frozen=True)
class BackoffPolicy:
    """`delays()` yields `max_retries` sleep durations: exponential from
    `base_s`, capped at `cap_s`, with multiplicative jitter drawn from
    `[1 - jitter, 1]` so a jittered delay never exceeds the cap."""

    base_s: float = 0.05
    cap_s: float = 2.0
    max_retries: int = 8
    jitter: float = 0.5
    seed: Optional[int] = None

    def __post_init__(self):
        if self.base_s <= 0 or self.cap_s < self.base_s:
            raise ValueError(f"need 0 < base_s <= cap_s, got "
                             f"{self.base_s}/{self.cap_s}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0: {self.max_retries}")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1]: {self.jitter}")

    def delays(self) -> Iterator[float]:
        rng = random.Random(self.seed)
        for k in range(self.max_retries):
            d = min(self.base_s * (2.0 ** k), self.cap_s)
            yield d * (1.0 - self.jitter * rng.random())
