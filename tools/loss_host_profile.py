#!/usr/bin/env python3
"""Where a bf16 train step's micro-batch waits on the host: one arch at
``chip_smoke.py``'s production-dtype train config (BF16_TRAIN), on one GPU.

    python3 tools/loss_host_profile.py [--arch gemma2-9b] [--rounds 3]

Builds the run as ``chip_smoke.train_phase(arch, production=True)`` does,
then for `rounds` micro-batches times the V-trace loss (the forward) and
its gradients (the backward) on the host clock and on CUDA events, each
ending in a synchronise; then one micro-batch's loss under
``torch.profiler`` (CPU and CUDA), its operators sorted by their own host
time and by their own device time. Needs CUDA.
"""

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.core.losses import make_vtrace_loss, param_grads  # noqa: E402
from repro_torch.launch import train  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b", choices=sorted(chip_smoke.BF16_TRAIN))
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    chip_smoke.log(f"card: {chip_smoke.card_identity()}")
    over = dict(chip_smoke.PRODUCTION, **chip_smoke.BF16_TRAIN[args.arch])
    b, s = over.pop("batch"), over.pop("seq", chip_smoke.TRAIN["seq"])
    run = train.setup(args.arch, batch=b, seq=s, steps=1, device="cuda", **over)
    state = run.make_state()
    if run.cfg.tie_embeddings:
        chip_smoke.live_table(state["params"], run.cfg)
    named = dict(state["params"].named_parameters())
    loss_fn = make_vtrace_loss(run.bundle)
    micro = {k: v[:b // max(1, run.cfg.grad_accum)] for k, v in run.batch_at(0).items()}
    chip_smoke.log(f"{args.arch}: a micro-batch of {tuple(micro['tokens'].shape)} tokens, "
                   f"{run.cfg.num_layers} layers, bf16, remat {run.cfg.remat}")
    for i in range(args.rounds):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        loss, _ = loss_fn(state["params"], micro)
        ev[1].record()
        t1 = time.perf_counter()
        grads = param_grads(loss, named)
        ev[2].record()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        chip_smoke.log(f"micro-batch {i}: forward {1e3 * (t1 - t0):.1f} ms on the host clock "
                       f"(to its last launch), {ev[0].elapsed_time(ev[1]):.1f} ms on CUDA events; "
                       f"backward {1e3 * (t2 - t1):.1f} ms, {ev[1].elapsed_time(ev[2]):.1f} ms")
        del loss, grads
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loss, _ = loss_fn(state["params"], micro)
        torch.cuda.synchronize()
    table = prof.key_averages()
    print(table.table(sort_by="self_cpu_time_total", row_limit=15, max_name_column_width=60))
    print(table.table(sort_by="self_cuda_time_total", row_limit=10, max_name_column_width=60))


if __name__ == "__main__":
    main()
