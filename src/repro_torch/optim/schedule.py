"""LR schedules as step -> lr callables. Mirrors ``repro.optim.schedule``,
on host floats: `step` is a Python int, so reading the rate never waits on
the device."""

import math


def linear_warmup(peak, warmup_steps):
    def fn(step):
        return peak * min(1.0, (step + 1.0) / warmup_steps)
    return fn


def cosine_schedule(peak, warmup_steps, total_steps, floor=0.1):
    def fn(step):
        warm = min(1.0, (step + 1.0) / warmup_steps)
        t = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        cos = floor + (1.0 - floor) * 0.5 * (1.0 + math.cos(math.pi * t))
        return peak * warm * cos
    return fn
