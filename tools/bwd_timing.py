#!/usr/bin/env python3
"""K1's fp32 forward, K1-bwd and K4-bwd at recurrentgemma-2b's training
call, and the full-width train step, on one GPU, for one checkout of the
port.

    PYTHONPATH=<checkout>/src python3 tools/bwd_timing.py [--tag NAME] [--no-train]

Imports ``repro_torch`` from PYTHONPATH (some checkout's ``src``, so two
trees compare in one call, alternated), else from this checkout; the
timing helpers come from this checkout's ``chip_smoke.py``. Builds the
four kernels the training path runs, then times, by CUDA events behind a
sleeping kernel (``chip_smoke.time_ms``):
- K1 at the train call (B 4, S 256, 10 query heads on 1 kv head, D 256,
  fp32, window 2048, writing its log-sum-exp), beside SDPA's fp32
  forward on the same inputs;
- K1-bwd at the same call, with its device time split by kernel from a
  profiler trace (``chip_smoke.kernel_spans``), beside SDPA's fp32
  backward (forward and backward, less forward);
- K4-bwd at the train call (B 4, S 256, W 2560, fp32): warm (one set of
  inputs) and cold in L2 (four sets in rotation);
- unless ``--no-train``, the full-width train step through
  ``chip_smoke.train_phase`` (3 steps, then two timed steps on the host
  clock, the step's parts on CUDA events and a profiler breakdown by
  group).
Prints the card and one JSON line. Needs CUDA.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.append(str(ROOT))
sys.path.append(str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as K1  # noqa: E402
from repro_torch.kernels import rglru_scan as K4  # noqa: E402

B, S, H, KH, D, WINDOW, W = 4, 256, 10, 1, 256, 2048, 2560


def k1_calls(gen, dev):
    """(K1 forward, K1-bwd) at the train call, each beside SDPA's."""
    import torch.nn.functional as F
    rand = lambda *shape: torch.randn(*shape, generator=gen, device=dev)   # noqa: E731
    q, do = rand(B, S, H, D), rand(B, S, H, D)
    k, v = rand(B, S, KH, D), rand(B, S, KH, D)
    sc = D ** -0.5
    fwd = lambda: K1.flash_attention(q, k, v, scale=sc, window=WINDOW, return_lse=True)  # noqa
    fwd_ms = chip_smoke.time_ms("K1 fp32", fwd)
    o, lse = fwd()
    call = lambda: K1.flash_attention_bwd(q, k, v, o, lse, do, scale=sc, window=WINDOW)  # noqa
    ms = chip_smoke.time_ms("K1-bwd", call)
    split = chip_smoke.kernel_spans(call, ("flash_bwd_delta", "flash_bwd_dkdv",
                                           "flash_bwd_reduce", "flash_bwd_dq"))
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    i = torch.arange(S, device=dev)
    mask = (i[None, :] <= i[:, None]) & ((i[:, None] - i[None, :]) < WINDOW)
    sdpa = lambda: F.scaled_dot_product_attention(   # noqa: E731
        qt, kt, vt, attn_mask=mask, scale=sc, enable_gqa=True)
    sdpa_fwd = chip_smoke.time_ms("SDPA fp32 forward", sdpa, iters=10)
    both = chip_smoke.time_ms("SDPA fp32 forward and backward", lambda: torch.autograd.grad(
        sdpa(), (qt, kt, vt), dot), iters=10)
    return ({"ms": fwd_ms, "route": K1.route(q.dtype, D), "sdpa_fwd_ms": sdpa_fwd},
            {"ms": ms, "split_ms": split, "sdpa_bwd_ms": both - sdpa_fwd})


def k4_bwd(gen, dev):
    sets = []
    for _ in range(4):
        a = torch.sigmoid(torch.randn(B, S, W, generator=gen, device=dev) + 2.0)
        bb = torch.randn(B, S, W, generator=gen, device=dev) * 0.1
        sets.append((a, K4.rglru_scan(a, bb)[0], torch.randn(B, S, W, generator=gen,
                                                              device=dev)))
    a, y, dy = sets[0]
    warm = chip_smoke.time_ms("K4-bwd", lambda: K4.rglru_scan_bwd(a, y, None, dy, None))
    turn = [0]

    def cold():
        a, y, dy = sets[turn[0] % len(sets)]
        turn[0] += 1
        return K4.rglru_scan_bwd(a, y, None, dy, None)
    return {"ms": warm, "cold_ms": chip_smoke.time_ms("K4-bwd cold", cold, iters=32)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="")
    ap.add_argument("--no-train", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bwd_timing: needs a CUDA device", file=sys.stderr)
        return 2
    card = chip_smoke.card_identity()
    print(f"card: {card}; repro_torch from {Path(K1.__file__).parents[2]}", flush=True)
    build.build(("flash_attention", "flash_attention_bwd", "rglru_scan", "rglru_scan_bwd"))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    k1_fwd, k1_bwd = k1_calls(gen, dev)
    out = {"tag": args.tag, "card": card, "k1_fwd": k1_fwd, "k1_bwd": k1_bwd,
           "k4_bwd": k4_bwd(gen, dev)}
    torch.cuda.empty_cache()
    if not args.no_train:
        ops.reset_launch_counts()
        _, m = chip_smoke.train_phase()
        out["train"] = {k: m[k] for k in ("step_ms", "tokens_per_s", "parts_ms", "device_ms")}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
