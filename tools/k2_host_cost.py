#!/usr/bin/env python3
"""Host time of one call of K2's wrapper (decode attention) on one GPU.

    PYTHONPATH=<checkout>/src python3 tools/k2_host_cost.py [--calls 200] [--repeats 7]

Imports ``repro_torch`` from PYTHONPATH (some checkout's ``src``, so two
trees compare in one run), else from this checkout. At qwen3-14b's and
recurrentgemma-2b's decode calls (bf16) it times, on the host's clock,
`calls` calls of ``repro_torch.kernels.decode_attention.decode_attention``
while a sleeping kernel holds the stream: the launches only queue, so the
time is the wrapper's own Python, allocations and launches. Where the
wrapper has a ``plan``, it also times the plan's lookup (with the cached
SM count) and the workspace's allocation alone. Prints one JSON line of
medians over `repeats`, in microseconds a call. Needs CUDA.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.append(str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.kernels import decode_attention as K2  # noqa: E402

# (B, S, H, KH, D, valid length): the serving paths' decode calls
CALLS = {"qwen3-14b": (4, 512, 40, 8, 128, 264),
         "recurrentgemma-2b": (4, 576, 10, 1, 256, 520)}


def host_us(fn, calls, repeats):
    """Median host microseconds of one fn() over `repeats` runs of `calls`
    calls, each run queued behind a sleeping kernel; refuses a run in which
    the stream woke before the host had queued every call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        woke = torch.cuda.Event()
        torch.cuda._sleep(200_000_000)   # cycles, ~100 ms at the H100's 1.98 GHz
        woke.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        if woke.query():
            raise RuntimeError("the stream woke before every call was queued")
        torch.cuda.synchronize()
        runs.append((t1 - t0) / calls * 1e6)
    return statistics.median(runs)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--repeats", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs CUDA")
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"wrapper": K2.__file__}
    for name, (b, s, h, kh, d, n) in CALLS.items():
        q = torch.randn(b, h, d, generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn(b, s, kh, d, generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        ln = torch.full((b,), n, dtype=torch.int32, device=dev)
        row = {"call_us": host_us(lambda: K2.decode_attention(q, k, v, ln),
                                  args.calls, args.repeats)}
        if hasattr(K2, "plan"):
            row["plan_us"] = host_us(
                lambda: K2.plan(b, s, h, kh, d, q.dtype, K2.num_sms(dev.index)),
                args.calls, args.repeats)
            splits = K2.plan(b, s, h, kh, d, q.dtype, K2.num_sms(dev.index))[1]
            row["workspace_us"] = host_us(
                lambda: torch.empty((splits, b, h, d + 2), dtype=torch.float32, device=dev),
                args.calls, args.repeats)
        out[name] = row
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
