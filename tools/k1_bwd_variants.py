#!/usr/bin/env python3
"""K1-bwd (the fp32 attention backward, or with ``--bf16`` its bf16 route)
beside diagnostic variants of its source, at recurrentgemma-2b's training
call (bf16: qwen3-14b's micro-batch call), on one GPU.

    python3 tools/k1_bwd_variants.py [--bf16] [--baseline PATH]

Each variant is ``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``
with one piece replaced, to show which resource the kernel spends its time
on; none is a design the port ships:
- ``one_tf32``: each product one TF32 product (a_big b_big) instead of
  three: the tensor pipe's share of the time (not fp32-grade);
- ``no_split``: each operand handed to the tensor core as it is, with a
  zero small part: the share of the integer ops that split the operands;
- ``no_scores``: the score products (K.Q^T, V.dO^T and their dQ-side
  twins) skipped, their tile taken as zeros: their share;
- ``no_products``: the D-wide products (dV, dK, dQ) skipped: their share;
- ``no_stream``: only the first streamed tile loaded (later tiles read a
  stale stage): the share of the global loads behind the compute;
- ``no_prefetch``: each tile waits for the next tile's loads before its
  products, as one stage would (at D 256 one stage, 143 KB, still leaves
  one CTA an SM): what the second stage hides.
The bf16 route's variants (``--bf16``: its ``wgmma`` kernels on 64-row
tiles, timed at B 4, S 256, 40 query heads on 8 kv heads, D 128, causal,
and checked against ``ops.flash_attention_bwd_bf16_plain`` at
``chip_smoke.BF16_GRAD_TOL``):
- ``no_softmax``: P and dX taken as the score accumulators themselves (no
  exponential, no dX formula; the mask's select kept): the share of the
  CUDA-core work;
- ``no_scores``: the score products skipped: their share;
- ``no_wide``: the D-wide products (dV, dK, dQ) skipped: their share;
- ``serial_scores``: a wait after the first score product before the
  second is issued: what issuing both before one wait buys.
``--baseline`` adds another ``flash_attention_bwd.cu`` with the same C entry
point (another checkout's), built as it is. All are built by
``build.compile_sources`` into ``build/kernels/k1_bwd_variants/``, checked
against ``ops.flash_attention_bwd_plain`` at the train call (the shipped
source and the baseline at ``chip_smoke.GRAD_TOL`` of each gradient's max;
the variants report their error), then timed at the train call (B 4, S 256,
10 query heads on 1 kv head, D 256, fp32, window 2048) by
``chip_smoke.time_ms``, each build in turn, ROUNDS times, with its device
time by kernel from a profiler trace (``chip_smoke.kernel_spans``). Prints
the card, each build's registers and spills from ``-Xptxas -v``, and one
JSON line a build. Needs CUDA.
"""

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from chip_smoke import (BF16_GRAD_TOL, GRAD_TOL, card_identity, kernel_spans,  # noqa: E402
                        time_ms)
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as K1  # noqa: E402
from kernel_source import patched, standalone  # noqa: E402

ROUNDS = 2
B, S, H, KH, D, WINDOW = 4, 256, 10, 1, 256, 2048
SPLIT = ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_reduce", "flash_bwd_dq")
# variant -> [(regex of a piece of the shipped source, its replacement)]
VARIANTS = {
    "one_tf32": [(r"  mma_tf32\((c|lo), a\.small, b\.big\);\n  mma_tf32\(\1, a\.big, b\.small\);\n",
                  "")],
    "no_split": [(r"  big = \(__float_as_uint\(x\) \+ 0x1000u\) & 0xFFFFE000u;\n"
                  r"  small = __float_as_uint\(x - __uint_as_float\(big\)\);\n",
                  "  big = __float_as_uint(x);\n  small = 0u;\n")],
    "no_scores": [(r"score_tile<D>\([^;]*;", "x[0] = x[1] = x[2] = x[3] = 0.f;")],
    "no_products": [(r"for \(int kk = split \* KPS; kk < \(split \+ 1\) \* KPS; \+\+kk\)",
                     "for (int kk = 0; kk < 0; ++kk)")],
    "no_stream": [(r"if \((q0 \+ BQ < q_end|k0 \+ BKV < kv_end)\) \{", "if (false) {")],
    "no_prefetch": [(r"cp_async_wait<1>\(\);", "cp_async_wait<0>();")],
}
BF16_CALL = (4, 256, 40, 8, 128)   # qwen3-14b's micro-batch call, causal
BF16_VARIANTS = {
    "no_softmax": [(r"p\[e\] = exp_sfu\(x - l\);", "p[e] = x + 0.f * l;"),
                   (r"dx\[e\] = p\[e\] \* \(dp\[i \+ e\] - del\) \* dxdt;",
                    "dx[e] = dp[i + e] + 0.f * (del + dxdt);")],
    "no_scores": [(r"    score<D>\((sacc|pacc), [^;]*;\n", "")],
    "no_wide": [(r"wide<DV>\((dva|dka|dqa\[c\]), [^;]*;", ";")],
    "serial_scores": [(r"(    score<D>\(sacc, [^;]*;\n)",
                       r"\1    hopper::wgmma_commit();\n    hopper::wgmma_wait<0>();\n")],
}


def variant_source(name, variants=VARIANTS) -> str:
    return patched(standalone((build.CSRC / "flash_attention_bwd.cu").read_text()),
                   variants[name], f"variant {name}")


def build_all(baseline=None, route="tf32x3") -> dict:
    """{key: (typed entry point of `route`, max registers, spill bytes)}."""
    variants = VARIANTS if route == "tf32x3" else BF16_VARIANTS
    out_dir = build.BUILD_DIR / "k1_bwd_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    texts = {"shipped": standalone((build.CSRC / "flash_attention_bwd.cu").read_text())}
    texts.update((name, variant_source(name, variants)) for name in variants)
    if baseline:   # another checkout's source: its headers are this checkout's
        texts["baseline"] = standalone(Path(baseline).read_text())
    jobs = {}
    for key, text in texts.items():
        cu = out_dir / f"flash_attention_bwd_{key}.cu"
        cu.write_text(text)
        jobs[key] = (cu, out_dir / f"libflash_attention_bwd_{key}.so")
    reports = build.compile_sources(jobs)
    built = {}
    for key, (_, lib) in jobs.items():
        log = reports[key]
        regs = max(int(x) for x in re.findall(r"Used (\d+) registers", log))
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", log))
        built[key] = (K1.bwd_entry(ctypes.CDLL(str(lib)), route), regs, spills)
    return built


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="another flash_attention_bwd.cu to time beside")
    ap.add_argument("--bf16", action="store_true", help="the bf16 route at qwen3-14b's call")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_bwd_variants: needs a CUDA device", file=sys.stderr)
        return 2
    card = card_identity()
    print(f"card: {card}", flush=True)
    built = build_all(args.baseline, "bf16" if args.bf16 else "tf32x3")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, s, h, kh, d = BF16_CALL if args.bf16 else (B, S, H, KH, D)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    rand = lambda *shape: torch.randn(*shape, generator=gen, device=dev).to(dtype)   # noqa: E731
    q, do = rand(b, s, h, d), rand(b, s, h, d)
    k, v = rand(b, s, kh, d), rand(b, s, kh, d)
    kw = dict(scale=d ** -0.5) if args.bf16 else dict(scale=d ** -0.5, window=WINDOW)
    o, lse = K1.flash_attention(q, k, v, return_lse=True, **kw)
    plain = ops.flash_attention_bwd_bf16_plain if args.bf16 else ops.flash_attention_bwd_plain
    want = [w.float() for w in plain(q, k, v, o, lse, do, **kw)]
    tol, split = (BF16_GRAD_TOL, K1.BWD_BF16_KERNELS) if args.bf16 else (GRAD_TOL, SPLIT)
    calls, errs = {}, {}
    for key, (fn, _, _) in built.items():
        calls[key] = lambda fn=fn: K1.bwd_launch(fn, q, k, v, o, lse, do, **kw)
        got = calls[key]()
        torch.cuda.synchronize()
        errs[key] = [float((g.float() - w).abs().max() / w.abs().max())
                     for g, w in zip(got, want)]
        if key in ("shipped", "baseline") and max(errs[key]) > tol:
            raise AssertionError(f"{key}: gradients off by {errs[key]} of their max")
    runs = {key: [] for key in built}
    for _ in range(ROUNDS):
        for key, call in calls.items():
            runs[key].append((time_ms(f"K1-bwd {key}", call), kernel_spans(call, split)))
    for key, found in runs.items():
        _, regs, spills = built[key]
        print(json.dumps({"build": key, "ms": [r[0] for r in found],
                          "split_ms": [r[1] for r in found], "registers": regs,
                          "spill_bytes": spills, "rel_err_dq_dk_dv": errs[key]}), flush=True)
    print(json.dumps({"card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
