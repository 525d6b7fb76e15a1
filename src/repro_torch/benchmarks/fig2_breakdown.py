"""Fig 2 on the card: sequential-idealization bottleneck breakdown.

The paper idealized V100 components (NVArchSim) for SEED-RL/R2D2 and found
Math 57% / SM-util 15% / DRAM-BW 12% / other 16%. The port's counterpart
of ``benchmarks/fig2_breakdown.py`` prints two attributions:

  * the reference's analytic R2D2 rows on one V100 (`r2d2_paper_terms`),
    equal to the reference's;
  * the card's row, in place of the reference's dry-run cells: one R2D2
    learner step at the published widths (batch 64 x 120 steps, fp32, TF32
    off), built as ``launch/train_r2d2.py`` builds it from a seed. Its
    wall time (host clock around a synchronised step) and its device-busy
    time (``torch.profiler``) by kernel group split the wall into the
    host's share (1 - busy/wall, the paper's "other"), the kernels whose
    FLOPs are not counted ("uncounted"), and the convolutions and GEMMs,
    whose time the roofline terms split into math, occupancy and memory.
    The FLOPs are what ``torch.utils.flop_counter.FlopCounterMode`` counts
    over the step (matmuls and convolutions, not elementwise work), over
    `H100_SXM`'s fp32 rate outside the tensor cores (`H100_FP32_FLOPS`, the
    rate the step runs at); the bytes are the reference formula at the
    step's shapes, over the card's HBM rate. The occupancy derate is the
    one that makes the terms add up to the counted kernels' time:
    calibrated on the card, where the reference's 0.75 is set by hand.
    Readings that cannot describe one step (busy beyond the wall, counted
    FLOPs that do not fit in the counted time) raise; nothing is clamped.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig2_breakdown [--smoke] [--device cuda|cpu]

``--smoke`` takes the example's reduced agent (``train_r2d2``'s config)
at batch 4. Without ``--device cpu`` it runs on the card and raises where
there is none; on the CPU the "device" is the host, and its busy time the
time spent in PyTorch's operators.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.r2d2_atari import AtariConfig
from repro_torch.core.bottleneck import (RooflineTerms, paper_fig2_reference,
                                         sequential_idealization, terms_from_hlo)
from repro_torch.device import resolve
from repro_torch.hw import H100_FP32_FLOPS, H100_SXM, V100

BATCH = 64
# the reduced agent of launch/train_r2d2.py's command line
SMOKE_AGENT = AtariConfig(obs_size=42, obs_channels=2, core_dim=128, num_actions=6,
                          burn_in=4, unroll=16, n_step=3, target_update_period=50)
SMOKE_BATCH = 4
SHARES = ("math", "occupancy", "memory", "collective")
# the profiler's groups of a step's device time; FlopCounterMode counts the
# FLOPs of the COUNTED groups and of none of the others
GROUPS = ("conv", "gemm", "lstm_gates", "other")
COUNTED = ("conv", "gemm")
_CONV = ("conv", "cudnn", "fprop", "dgrad", "wgrad", "nchw", "nhwc", "fft", "cf32")
_GEMM = ("gemm", "gemv", "cutlass", "nvjet", "xmma", "cublas")
_ATEN_GEMM = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::matmul",
              "aten::linear")


def r2d2_paper_terms():
    """Analytic roofline of the R2D2 learner batch on one V100.

    batch 64 x unroll 80, conv-LSTM ~2M params: per train step
    FLOPs ~= 6 * 2e6 * (64*80) * ~8 (conv reuse) — calibrated so the
    attribution lands near the paper's measured split; occupancy 0.72
    reflects the paper's 15% SM-utilization loss."""
    flops = 6 * 2e6 * 64 * 80 * 8.0
    hbm = 64 * 80 * (84 * 84 * 4 + 4 * 512 * 4) * 3.0
    return terms_from_hlo(flops, hbm, 0.0, 1, V100, occupancy=0.75)


def paper_rows():
    """(component, the analytic V100 attribution, the paper's share)."""
    ref = paper_fig2_reference()
    out = sequential_idealization(r2d2_paper_terms())
    return [(k, out[k], ref.get(k, 0.0)) for k in SHARES]


def build_r2d2_step(acfg=None, batch_size=BATCH, device="cuda", seed=0):
    """One R2D2 learner step as ``launch/train_r2d2.py`` builds it: the
    agent from `seed`, AdamW at its learning rate, a target net, TF32 off
    on the card; and a batch of `batch_size` sequences of burn-in + unroll
    steps made with numpy from `seed`, moved as the system's learner moves
    a replay batch. Returns (train_step, state, batch)."""
    from repro_torch.core.losses import init_train_state, make_train_step
    from repro_torch.launch.train_r2d2 import LR, device_batch
    from repro_torch.models.atari import make_atari
    from repro_torch.optim import adamw

    acfg = acfg or AtariConfig()
    dev = resolve(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    bundle = make_atari(acfg)
    opt = adamw(LR)
    state = init_train_state(bundle, opt, seed, dev, with_target=True)
    train_step = make_train_step(bundle, opt, algo="r2d2", acfg=acfg)
    t = acfg.burn_in + acfg.unroll
    rng = np.random.default_rng(seed)
    batch = {"obs": rng.integers(0, 256, (batch_size, t, acfg.obs_size, acfg.obs_size,
                                          acfg.obs_channels), dtype=np.uint8),
             "actions": rng.integers(0, acfg.num_actions, (batch_size, t)).astype(np.int32),
             "rewards": (rng.random((batch_size, t)) < 0.05).astype(np.float32),
             "dones": (rng.random((batch_size, t)) < 0.002).astype(np.float32)}
    return train_step, state, device_batch(batch, dev, acfg.core_dim)


def step_flops(train_step, state, batch):
    """(FLOPs FlopCounterMode counts over one step, the state after it)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        state, _ = train_step(state, batch)
    return counter.get_total_flops(), state


def step_bytes(acfg, batch_size):
    """The reference's HBM bytes (``benchmarks/fig2_breakdown.py:24``) at
    the step's shapes: each of the B x (burn-in + unroll) frames and four
    fp32 vectors of the core width, moved three times."""
    t = acfg.burn_in + acfg.unroll
    return batch_size * t * (acfg.obs_size ** 2 * acfg.obs_channels + 4 * acfg.core_dim * 4) * 3.0


def _union_s(spans):
    """Seconds covered by (start, end) spans in microseconds, each instant
    once however many spans cover it."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e6


def kernel_group(name):
    """The group of a kernel (on the CPU, of a PyTorch operator) by its
    name: cuDNN's convolutions (with their layout copies and the complex
    GEMMs and transforms of its FFT algorithms; the agent has no other
    complex arithmetic), GEMMs, the LSTM gates' sigmoid and tanh (forward
    and backward), and everything else."""
    n = name.lower()
    if any(k in n for k in _CONV):
        return "conv"
    if n in _ATEN_GEMM or any(k in n for k in _GEMM):
        return "gemm"
    if "sigmoid" in n or "tanh" in n:
        return "lstm_gates"
    return "other"


def device_spans(prof, device):
    """(name, start, end) in microseconds of what ran on the device in a
    profiler trace: the card's kernels, or on the CPU PyTorch's
    operators."""
    if device.type == "cuda":
        return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("aten::")]


def busy_groups_s(spans):
    """Seconds the device was busy over `spans`, each instant once: in all
    ("busy"), in each of GROUPS, and in the COUNTED groups together
    ("counted")."""
    by = {g: [] for g in GROUPS}
    for name, start, end in spans:
        by[kernel_group(name)].append((start, end))
    out = {g: _union_s(found) for g, found in by.items()}
    out["busy"] = _union_s([s for found in by.values() for s in found])
    out["counted"] = _union_s([s for g in COUNTED for s in by[g]])
    return out


def measure_step(train_step, state, batch, warm=3, timed=5):
    """Wall seconds of a step and the device-busy seconds of one profiled
    step by group (`busy_groups_s`). On the card the wall is the mean of
    `timed` steps (host clock around a synchronised step), unprofiled: the
    profiler slows the host, not the card's kernels. On the CPU the
    "device" is the host, whose operators the profiler slows too, so the
    wall is the profiled step's own. Returns (wall_s, groups, state)."""
    from torch.profiler import ProfilerActivity, profile

    dev = batch["obs"].device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    walls = []
    for i in range(warm + timed):
        sync()
        t0 = time.perf_counter()
        state, _ = train_step(state, batch)
        sync()
        if i >= warm:
            walls.append(time.perf_counter() - t0)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        state, _ = train_step(state, batch)
        sync()
        profiled_s = time.perf_counter() - t0
    wall_s = sum(walls) / len(walls) if dev.type == "cuda" else profiled_s
    return wall_s, busy_groups_s(device_spans(prof, dev)), state


def card_row(flops, hbm_bytes, wall_s, busy_s, counted_s, peak_flops=H100_FP32_FLOPS,
             chip=H100_SXM):
    """The card's attribution of one step in shares of its wall time:
    "other", the host's share (1 - busy/wall); "uncounted", the device time
    of the kernels whose FLOPs FlopCounterMode does not count (the LSTM
    gates, AdamW, the loss; busy - counted); and the counted kernels' time
    `counted_s` (convolutions and GEMMs) split by `sequential_idealization`
    of the roofline terms (compute at `peak_flops`, memory at the chip's
    HBM rate, no collective), with the occupancy derate that makes those
    terms add up to `counted_s`.

    Raises ValueError where the readings cannot describe one step: the
    counted time must lie within the busy time and that within the wall,
    and the counted FLOPs at the peak rate plus the memory term must fit in
    the counted time (else the FLOP count, the rate or the grouping is
    wrong). Nothing is clamped."""
    compute_s = flops / peak_flops
    memory_s = hbm_bytes / chip.hbm_bandwidth
    if not 0 < counted_s <= busy_s <= wall_s:
        raise ValueError(f"counted {counted_s:.6g} s, busy {busy_s:.6g} s, wall {wall_s:.6g} s: "
                         "each must lie within the next")
    if not 0 < compute_s <= counted_s - memory_s:
        raise ValueError(f"{flops:.4g} FLOPs at {peak_flops:.4g} FLOP/s take {compute_s:.6g} s, "
                         f"which does not fit in the counted kernels' {counted_s:.6g} s less "
                         f"the memory term's {memory_s:.6g} s")
    occupancy = compute_s / (counted_s - memory_s)
    terms = RooflineTerms(compute_s=compute_s, memory_s=memory_s, collective_s=0.0,
                          occupancy=occupancy)
    ideal = sequential_idealization(terms)
    shares = {k: ideal[k] * counted_s / wall_s for k in SHARES}
    shares["uncounted"] = (busy_s - counted_s) / wall_s
    shares["other"] = 1.0 - busy_s / wall_s
    return {"flops": flops, "hbm_bytes": hbm_bytes, "peak_flops": peak_flops,
            "wall_s": wall_s, "busy_s": busy_s, "counted_s": counted_s, "compute_s": compute_s,
            "memory_s": memory_s, "occupancy": occupancy, "model_s": terms.total(),
            "shares": shares}


def paper_lines():
    return [f"fig2_r2d2_{k},{v:.3f},paper={p:.2f}" for k, v, p in paper_rows()]


def card_lines(row, where):
    ref = paper_fig2_reference()
    out = [f"fig2_card_r2d2_{k},{row['shares'][k]:.3f},paper={ref.get(k, 0.0):.2f}"
           for k in SHARES]
    out.append(f"fig2_card_r2d2_uncounted,{row['shares']['uncounted']:.3f},paper=none "
               "(kernels FlopCounterMode does not count: LSTM gates, AdamW, the loss)")
    out.append(f"fig2_card_r2d2_other,{row['shares']['other']:.3f},paper={ref['other']:.2f}")
    out.append(
        f"fig2_card_r2d2_step_ms,{1e3 * row['wall_s']:.3f},wall (host clock) "
        f"busy_ms={1e3 * row['busy_s']:.3f} counted_ms={1e3 * row['counted_s']:.3f} (convolutions "
        f"and GEMMs) compute_ms={1e3 * row['compute_s']:.3f} "
        f"memory_ms={1e3 * row['memory_s']:.4f} occupancy_derate={row['occupancy']:.3f} "
        f"(compute over counted less memory, calibrated on {where}; the reference sets 0.75 by "
        f"hand) flops={row['flops']:.4g} (FlopCounterMode: matmuls and convolutions, no "
        f"elementwise) at {row['peak_flops'] / 1e12:.0f} TFLOP/s (H100 fp32, no tensor "
        f"cores) hbm_bytes={row['hbm_bytes']:.4g}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the example's reduced agent at batch 4 in place of the published one")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises where there is no card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    acfg, batch_size = (SMOKE_AGENT, SMOKE_BATCH) if args.smoke else (AtariConfig(), BATCH)
    print("# fig2: the reference's analytic R2D2 terms on one V100")
    print("name,value,derived")
    print("\n".join(paper_lines()))
    train_step, state, batch = build_r2d2_step(acfg, batch_size, dev)
    flops, state = step_flops(train_step, state, batch)
    wall, groups, state = measure_step(train_step, state, batch)
    row = card_row(flops, step_bytes(acfg, batch_size), wall, groups["busy"], groups["counted"])
    print(f"# fig2 on {where}: one R2D2 learner step, batch {batch_size} x "
          f"{acfg.burn_in + acfg.unroll}, {acfg.obs_size}x{acfg.obs_size}x{acfg.obs_channels}, "
          f"core {acfg.core_dim}, fp32")
    print("\n".join(card_lines(row, where)))
    return row


if __name__ == "__main__":
    main()
