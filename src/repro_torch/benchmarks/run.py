"""Benchmark runner: one section per paper figure, then a train/serve
micro-benchmark. Prints ``name,value,derived`` CSV.

The port's counterpart of ``benchmarks/run.py``. Figs 2, 3 and 4 run at
their ``--smoke`` windows with ``--smoke``. The reference's roofline table
reads the XLA dry-run's artifacts, which the port does not make yet: that
section prints one line saying so. The micro-benchmark times one train
step and one serve step of the tiny qwen3 config (eager) with
`timing.device_ms`: CUDA events on the card, the host clock on the CPU. A
failed Fig 4 shm gate still exits non-zero, after the other sections
ran.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--smoke] [--device cuda|cpu]
"""

import argparse
import sys

import torch

from repro_torch.benchmarks import fig2_breakdown, fig3_actor_scaling, fig4_cpu_gpu_ratio
from repro_torch.benchmarks.timing import device_ms
from repro_torch.device import resolve


def microbench_train_step(device="cuda", n=20):
    """us_per_call of the tiny qwen3 train step (V-trace loss, AdamW) and
    serve step (one decode token, batch 4), eager on `device`."""
    from repro_torch.configs.registry import make_model, smoke_config
    from repro_torch.core.losses import init_train_state, make_train_step
    from repro_torch.envs.tokenworld import synthetic_vtrace_batch
    from repro_torch.launch.serve import make_prefill, make_serve_step
    from repro_torch.optim import adamw

    dev = resolve(device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    clock = "CUDA events" if dev.type == "cuda" else "host clock"
    print(f"# microbench: eager train/serve steps (tiny qwen3) on {where}, {clock}")
    print("name,us_per_call,derived")
    cfg = smoke_config("qwen3-14b")
    bundle = make_model(cfg)
    opt = adamw(1e-3)
    step = make_train_step(bundle, opt)
    box = {"state": init_train_state(bundle, opt, 0, dev)}
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    batch = synthetic_vtrace_batch(gen, 4, 32, cfg.vocab_size)

    def train():
        box["state"], _ = step(box["state"], batch)

    us = 1e3 * device_ms(train, iters=n, warmup=1, device=dev)[0]
    print(f"train_step_tiny_qwen3,{us:.0f},tokens_per_s={4 * 32 / (us / 1e6):.0f}")

    params = box["state"]["params"]
    prefill = make_prefill(bundle, max_len=64, dtype=torch.float32)
    sstep = make_serve_step(bundle)
    tok, cache = prefill(params, {"tokens": torch.zeros((4, 32), dtype=torch.int32,
                                                        device=dev)})
    cur = {"tok": tok, "cache": cache}

    def serve():
        cur["tok"], cur["cache"] = sstep(params, cur["tok"], cur["cache"])

    us = 1e3 * device_ms(serve, iters=n, warmup=1, device=dev)[0]
    print(f"serve_step_tiny_qwen3,{us:.0f},decode_tokens_per_s={4 / (us / 1e6):.0f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="each figure's tiny windows")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises where there is no card) or cpu")
    args = ap.parse_args(argv)
    resolve(args.device)
    common = ["--device", args.device] + (["--smoke"] if args.smoke else [])
    print("=" * 72)
    print("== Fig 2: bottleneck breakdown (sequential idealization)")
    fig2_breakdown.main(common)
    print("=" * 72)
    print("== Fig 3: actor scaling (measured + calibrated model)")
    fig3_actor_scaling.main(common)
    print("=" * 72)
    print("== Fig 4 + Conclusion 3: accelerator derating & CPU/GPU ratio")
    try:
        fig4_cpu_gpu_ratio.main(common)
        gate = 0
    except SystemExit as e:     # Fig 4's shm gate: fail at the end, after the rest ran
        gate = e.code
    print("=" * 72)
    print("== Roofline table: waits for the port of launch/dryrun.py "
          "(ROADMAP queue 1 item 10), whose artifacts it reads")
    print("=" * 72)
    microbench_train_step(args.device)
    if gate:
        sys.exit(gate)


if __name__ == "__main__":
    main()
