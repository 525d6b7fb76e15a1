"""Timing of a call on the card or the host, shared by the figure scripts
and ``chip_smoke.py``."""

import time

import torch

# cycles of the sleeping kernel, about 50 ms at the H100's 1.98 GHz
SLEEP_CYCLES = 100_000_000


def device_ms(fn, iters=20, warmup=3, device="cuda"):
    """(mean ms of one call of `fn`, host_limited).

    On the card: CUDA events around `iters` calls, after a sleeping kernel
    that holds the stream for about 50 ms, so that the host queues every
    call before the first one runs; a call whose host side is slower than
    its kernels would otherwise time the host. `host_limited` says the
    stream woke before the host had queued every call, so the time
    includes host gaps. On the CPU: the host clock, `host_limited` None."""
    for _ in range(warmup):
        fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters, None
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_limited = start.query()
    end.synchronize()
    return start.elapsed_time(end) / iters, host_limited
