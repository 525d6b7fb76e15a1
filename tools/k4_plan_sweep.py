#!/usr/bin/env python3
"""K4 (the RG-LRU scan) at other plans than the shipped one, on one GPU.

    python3 tools/k4_plan_sweep.py [--baseline PATH]

Each plan (LW lanes a strip, T steps a chunk, NC chunks a tile, the CTAs
an SM must hold) is ``src/repro_torch/kernels/csrc/rglru_scan.cu`` with its
four constants replaced. The shipped source is built beside them as it is,
all by ``build.compile_sources`` into ``build/kernels/k4_sweep/``; each
reports its plan through its own ``rglru_scan_plan``. Each is checked
against ``ops.rglru_scan_plain`` at the serving call and at ragged S and
W, at the kernel tests' tolerances, then timed at the serving call (B 4,
S 512, W 2560; fp32 a and b, bf16 y, h0 in, state out) by
``chip_smoke.time_ms``: warm (one set of inputs, 52.5 MB against the 50 MB
L2) and cold (four sets in rotation, 210 MB). Beside them,
``torch.add(a, b, out=y)`` into the bf16 y moves the same bytes: an
elementwise pass, not the same function. Every build is timed in turn,
ROUNDS times. ``--baseline`` adds another ``rglru_scan.cu`` with the same
C entry point (another checkout's), built as it is and timed the same way.
Prints the card, each build's registers and spills from ``-Xptxas -v``,
and one JSON line a build. Needs CUDA.
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

from chip_smoke import card_identity, time_ms  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import rglru_scan as K4  # noqa: E402

ROUNDS = 2
# (LW, T, NC, MIN_CTAS), each MIN_CTAS the most CTAs of LW NC threads that
# the plan's registers allow; a strip of 64 lanes writes each row of a
# bf16 y as one 128-byte line
PLANS = [(32, 16, 8, 3), (32, 32, 16, 1), (32, 32, 8, 2), (32, 16, 4, 4), (32, 8, 4, 8),
         (32, 4, 8, 8), (32, 8, 16, 2), (32, 8, 8, 5), (64, 8, 4, 4), (64, 8, 8, 2),
         (64, 16, 4, 3)]
SERVING = (4, 512, 2560)
CHECKS = [(SERVING, torch.bfloat16, True), (SERVING, torch.float32, False),
          ((2, 4096, 256), torch.float32, True), ((1, 2049, 96), torch.bfloat16, True),
          ((3, 1, 37), torch.float32, True), ((1, 5, 37), torch.bfloat16, False)]


def plan_source(lw, t, nc, min_ctas) -> str:
    src = (build.CSRC / "rglru_scan.cu").read_text()
    for name, value in (("LW", lw), ("T", t), ("NC", nc), ("MIN_CTAS", min_ctas)):
        src, n = re.subn(rf"^constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                         src, flags=re.M)
        if n != 1:
            raise RuntimeError(f"no constant {name} in rglru_scan.cu")
    return src


def build_all(baseline=None) -> dict:
    """{key: (loaded library, ptxas registers, spill bytes)} for "shipped",
    each plan of PLANS and, if given, "baseline"."""
    out_dir = build.BUILD_DIR / "k4_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    texts = {"shipped": (build.CSRC / "rglru_scan.cu").read_text()}
    texts.update((p, plan_source(*p)) for p in PLANS)
    if baseline:
        texts["baseline"] = Path(baseline).read_text()
    jobs = {}
    for key, text in texts.items():
        stem = key if isinstance(key, str) else "lw{}_t{}_nc{}_min{}".format(*key)
        cu = out_dir / f"rglru_{stem}.cu"
        cu.write_text(text)
        jobs[key] = (cu, out_dir / f"librglru_{stem}.so")
    reports = build.compile_sources(jobs)
    built = {}
    for key, (_, lib) in jobs.items():
        log = reports[key]
        regs = max(int(x) for x in re.findall(r"Used (\d+) registers", log))
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", log))
        built[key] = (ctypes.CDLL(str(lib)), regs, spills)
    return built


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="another rglru_scan.cu to time beside the plans")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_plan_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    card = card_identity()
    print(f"card: {card}", flush=True)
    built = build_all(args.baseline)
    fns = {key: K4.entry(lib) for key, (lib, _, _) in built.items()}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(b, s, w, with_h0):
        a = torch.sigmoid(torch.randn(b, s, w, generator=gen, device=dev) + 2.0)
        bb = torch.randn(b, s, w, generator=gen, device=dev) * 0.1
        return a, bb, (torch.randn(b, w, generator=gen, device=dev) if with_h0 else None)

    worst = dict.fromkeys(built, 0.0)
    for shape, out_dt, with_h0 in CHECKS:
        a, bb, h0 = inputs(*shape, with_h0)
        yp, hp = ops.rglru_scan_plain(a, bb, h0=h0, out_dtype=out_dt)
        scale = max(float(yp.float().abs().max()), 1.0)
        tol = 2e-2 if out_dt == torch.bfloat16 else 1e-5
        for key, fn in fns.items():
            y = torch.empty(shape, dtype=out_dt, device=dev)
            h_last = torch.empty(shape[0], shape[2], device=dev)
            K4.launch(fn, a, bb, h0, y, h_last)
            torch.cuda.synchronize()
            torch.testing.assert_close(y.float(), yp.float(), atol=tol * scale, rtol=tol)
            torch.testing.assert_close(h_last, hp, atol=1e-5 * scale, rtol=1e-5)
            worst[key] = max(worst[key], float((y.float() - yp.float()).abs().max()))

    b, s, w = SERVING
    sets = [inputs(b, s, w, False)[:2] for _ in range(4)]
    ys = [torch.empty(b, s, w, dtype=torch.bfloat16, device=dev) for _ in range(4)]
    h0, h_last = torch.zeros(b, w, device=dev), torch.empty(b, w, device=dev)
    nbytes = 4 * 2 * b * s * w + 2 * b * s * w + 2 * 4 * b * w

    def rotating(call):
        turn = [0]

        def go():
            i = turn[0] % len(sets)
            turn[0] += 1
            call(i)
        return go

    runs = {key: [] for key in [*built, "add"]}
    for _ in range(ROUNDS):
        for key, fn in fns.items():
            def call(i, fn=fn):
                K4.launch(fn, sets[i][0], sets[i][1], h0, ys[i], h_last)
            runs[key].append((time_ms(f"K4 {key}", lambda: call(0), iters=50, warmup=5),
                              time_ms(f"K4 {key} cold", rotating(call), iters=50, warmup=5)))

        def add(i):
            torch.add(sets[i][0], sets[i][1], out=ys[i])
        runs["add"].append((time_ms("add", lambda: add(0), iters=50, warmup=5),
                            time_ms("add cold", rotating(add), iters=50, warmup=5)))

    for key, found in runs.items():
        row = {"warm_ms": [r[0] for r in found], "cold_ms": [r[1] for r in found],
               "cold_tb_s": nbytes / min(r[1] for r in found) / 1e9}
        if key == "add":
            row = {"plan": "torch.add(a, b, out=y bf16), the same bytes", **row}
        else:
            lib, regs, spills = built[key]
            desc = (f"baseline {args.baseline}" if key == "baseline"
                    else {**K4.plan(b, s, w, lib), "shipped": key == "shipped"})
            row = {"plan": desc, "registers": regs, "spill_bytes": spills,
                   "max_abs_err": worst[key], **row}
        print(json.dumps(row), flush=True)
    print(json.dumps({"card": card, "bytes": nbytes, "bound_ms": nbytes / 3.35e12 * 1e3}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
