"""Weight initializers: functions of (generator, shape, dtype, device).

Mirrors ``repro.nn.init``. Samples are drawn in fp32 in chunks of at most
``CHUNK`` elements and written into a tensor of the target dtype, so a
bf16 model is built without ever holding an fp32 copy of a whole
parameter set. JAX keys and torch generators give different numbers from
the same seed; parity tests convert JAX params instead (``convert.py``).
"""

import math

import torch

CHUNK = 1 << 26


def _fill(shape, dtype, device, sample):
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type == "meta":       # a shape, no values
        return out
    flat = out.view(-1)
    for i in range(0, flat.numel(), CHUNK):
        n = min(CHUNK, flat.numel() - i)
        flat[i:i + n].copy_(sample(n))
    return out


def normal(stddev=0.02):
    def init(gen, shape, dtype, device):
        return _fill(shape, dtype, device, lambda n: torch.randn(
            n, generator=gen, device=device) * stddev)
    return init


def fan_in(scale=1.0, in_axes=None):
    """Truncated normal on [-2, 2], scaled by 1/sqrt(fan_in).

    in_axes: which axes of `shape` constitute fan-in (default: all but last).
    """
    def init(gen, shape, dtype, device):
        axes = in_axes if in_axes is not None else tuple(range(len(shape) - 1))
        fan = math.prod(shape[a] for a in axes) or 1
        std = scale / math.sqrt(fan)

        def sample(n):
            t = torch.empty(n, device=device)
            return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                               generator=gen).mul_(std)
        return _fill(shape, dtype, device, sample)
    return init


def zeros(gen, shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


def ones(gen, shape, dtype, device):
    return torch.ones(shape, dtype=dtype, device=device)


def a_log_init(gen, shape, dtype, device):
    """Mamba2's A_log: log(uniform(1, 16)), so A = -exp(A_log) lies in
    [-16, -1] (``repro.nn.ssd.init_ssd_layer``)."""
    return _fill(shape, dtype, device, lambda n: torch.log(torch.rand(
        n, generator=gen, device=device) * 15.0 + 1.0))


def lru_a_init(min_rad=0.9, max_rad=0.999):
    """RG-LRU's Lambda, so that a = exp(-8 softplus(Lambda)) has a radius
    sqrt(uniform(min_rad^2, max_rad^2)) (``repro.nn.rglru``, c = 8)."""
    def init(gen, shape, dtype, device):
        def sample(n):
            u = torch.rand(n, generator=gen, device=device)
            a = torch.sqrt(min_rad ** 2 + u * (max_rad ** 2 - min_rad ** 2))
            softplus_lam = -torch.log(a) / 8.0
            return torch.log(torch.expm1(torch.clamp(softplus_lam, min=1e-8)))
        return _fill(shape, dtype, device, sample)
    return init


def dt_bias_init(dt_min=1e-3, dt_max=1e-1):
    """Mamba: dt bias so softplus(bias) is log-uniform in [dt_min, dt_max]."""
    lo, hi = math.log(dt_min), math.log(dt_max)

    def init(gen, shape, dtype, device):
        def sample(n):
            dt = torch.exp(torch.rand(n, generator=gen, device=device) * (hi - lo) + lo)
            return dt + torch.log(-torch.expm1(-dt))
        return _fill(shape, dtype, device, sample)
    return init
