#!/usr/bin/env python3
"""K3-bwd's bf16 ``wgmma`` route beside diagnostic variants of its source,
at mamba2-2.7b's bf16 training call, on one GPU.

    python3 tools/k3_bwd_variants.py [--only NAME ...]

Each variant is ``src/repro_torch/kernels/csrc/ssd_scan_bwd.cu`` with one
piece of the route's kernels (namespace ``wg``) replaced, to show where
their time goes; none is a design the port ships:
- ``no_scores``: the chunk kernel's score products (x dy^T and B C^T, or
  dy x^T and C B^T) skipped: their share;
- ``no_packs``: dG^T, dG and M not formed from the scores (no mask, no
  exponential, no hi + lo split, no M tiles, no R sums): the share of that
  CUDA-core work;
- ``no_wide``: dB += dG^T C, dC += dG B and dx += M^T dy skipped;
- ``no_planes``: the products with the planes of S_{c-1} and dS_c (B dS^T,
  x dS, dy S) skipped;
- ``no_ip``: <dS, S> over the planes skipped;
- ``no_dcs``: the warp that forms d(cs), ddt and da skipped;
- ``no_loads``: the chunk kernel's tiles loaded for its first two steps
  only (later steps read a stale stage): the share of the loads;
- ``no_state_store``: the state walk's planes not stored (the chunk kernel
  reads stale ones): the share of those stores.
All are built by ``build.compile_sources`` into
``build/kernels/k3_bwd_variants/``, checked against
``ops.ssd_scan_bwd_plain`` (the shipped source at ``chip_smoke``'s
tolerances; the variants report their error), then timed at the train
call (B 4, S 256, H 80, P 64, N 128, G 1, bf16, no h0, no d(final state))
by ``chip_smoke.time_ms``, each build in turn, ROUNDS times, with its
device time by kernel from a profiler trace (``chip_smoke.kernel_spans``).
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

from chip_smoke import (BF16_GRAD_TOL, GRAD_TOL, card_identity, kernel_spans,  # noqa: E402
                        time_ms)
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import ssd_scan as K3  # noqa: E402
from kernel_source import patched, standalone  # noqa: E402

ROUNDS = 2
B, S, H, P, N, G = 4, 256, 80, 64, 128, 1
# variant -> [(regex of a piece of the shipped source, its replacement)]
VARIANTS = {
    "no_scores": [(r"kmajor\(dm, [^;]*;", ";"), (r"kmajor\(gs, [^;]*;", ";")],
    "no_packs": [(r"for \(int j8 = 0; j8 < 8; \+\+j8\) \{\n(\s*)const int k0 = 8 \* j8 \+ c0;",
                  r"for (int j8 = 0; j8 < 0; ++j8) {\n\1const int k0 = 8 * j8 + c0;")],
    "no_wide": [(r"wide<N>\(acc, dg, [^;]*;", ";"),
                (r"hopper::wgmma_m64n64k16_ss_tt\([^;]*;", ";")],
    "no_planes": [(r"kmajor\(u, w\.sb, [^;]*;", ";"), (r"by_planes\((v|z), [^;]*;", ";")],
    "no_ip": [(r"for \(int k = wt; k < NT / 16; k \+= WG\)", "for (int k = wt; k < 0; k += WG)")],
    "no_dcs": [(r"if \(!S_ROWS && warp == 0\) \{", "if (false) {")],
    "no_loads": [(r"if \(i \+ STAGES < w\.nsteps\) w\.issue<N>\(i \+ STAGES\);",
                  "if (i + STAGES < w.nsteps) hopper::mbar_arrive(w.full0 + 8 * stg);")],
    "no_state_store": [(r"hopper::tma_store_4d\(&tws, [^;]*;", ";")],
}


def build_all(names) -> dict:
    """{key: (typed wgmma entry point, max registers, spill bytes)}."""
    out_dir = build.BUILD_DIR / "k3_bwd_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = standalone((build.CSRC / "ssd_scan_bwd.cu").read_text())
    texts = {"shipped": src}
    texts.update((name, patched(src, VARIANTS[name], f"variant {name}")) for name in names)
    jobs = {}
    for key, text in texts.items():
        cu = out_dir / f"ssd_scan_bwd_{key}.cu"
        cu.write_text(text)
        jobs[key] = (cu, out_dir / f"libssd_scan_bwd_{key}.so")
    reports = build.compile_sources(jobs)
    built = {}
    for key, (_, lib) in jobs.items():
        entries = reports[key].split("Compiling entry function")[1:]
        mine = [e for e in entries if "ssd_bwd_wgmma_" in e.split("\n")[0]]
        regs = max(int(re.search(r"Used (\d+) registers", e).group(1)) for e in mine)
        spills = sum(int(x) for e in mine for x in re.findall(r"(\d+) bytes spill stores", e))
        fn = ctypes.CDLL(str(lib)).ssd_scan_bwd_wgmma
        fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        built[key] = (fn, regs, spills)
    return built


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", choices=sorted(VARIANTS), default=sorted(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_bwd_variants: needs a CUDA device", file=sys.stderr)
        return 2
    card = card_identity()
    print(f"card: {card}", flush=True)
    built = build_all(args.only)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    rand = lambda *shape: torch.randn(*shape, generator=gen, device=dev)   # noqa: E731
    x = (rand(B, S, H, P) * 0.5).to(bf)
    dt = torch.nn.functional.softplus(rand(B, S, H) - 2.0)
    a = -torch.exp(rand(H) * 0.5 + 1.0)
    bm, cm = ((rand(B, S, G, N) * 0.3).to(bf) for _ in range(2))
    dy = rand(B, S, H, P).to(bf)
    want = ops.ssd_scan_bwd_plain(x, dt, a, bm, cm, None, dy, None)
    shipped_fn = K3._bwd_fn
    calls, errs = {}, {}
    try:
        for key, (fn, _, _) in built.items():
            def call(fn=fn):
                K3._bwd_fn = lambda route: fn   # this build's entry point for the wgmma route
                return K3.ssd_scan_bwd(x, dt, a, bm, cm, None, dy, None)
            calls[key] = call
            got = call()
            torch.cuda.synchronize()
            errs[key] = [float((g.float() - w.float()).abs().max() / w.float().abs().max())
                         for g, w in zip(got, want) if w is not None]
            if key == "shipped":
                tols = [BF16_GRAD_TOL if w.dtype == bf else GRAD_TOL for w in want if w is not None]
                if any(e > t for e, t in zip(errs[key], tols)):
                    raise AssertionError(f"shipped: gradients off by {errs[key]} of their max")
        runs = {key: [] for key in built}
        for _ in range(ROUNDS):
            for key, call in calls.items():
                runs[key].append((time_ms(f"K3-bwd {key}", call),
                                  kernel_spans(call, K3.BWD_WGMMA_KERNELS)))
    finally:
        K3._bwd_fn = shipped_fn
    for key, found in runs.items():
        _, regs, spills = built[key]
        print(json.dumps({"build": key, "ms": [r[0] for r in found],
                          "split_ms": [r[1] for r in found], "registers": regs,
                          "spill_bytes": spills,
                          "rel_err_dx_ddt_da_db_dc": errs[key]}), flush=True)
    print(json.dumps({"card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
