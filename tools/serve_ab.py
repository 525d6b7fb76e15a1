#!/usr/bin/env python3
"""chip_smoke.py's serve phases from two or more checkouts in turn, on one GPU.

    python3 tools/serve_ab.py --tree A --tree B --tree B --tree A \\
        [--arch qwen3-14b --arch mamba2-2.7b ...] [--log FILE]

Each ``--tree`` is the root of a checkout (a ``git archive`` of a commit
will do); give them alternated (A, B, B, A) so that a drift of the card or
the host shows. For each, in the order given, a child process of its own
imports that checkout's ``chip_smoke.py`` and ``src/``, builds its kernels,
and runs ``chip_smoke.serve_phase`` for each arch (default: every arch of
the checkout's ``SERVE``), with nothing else running on the machine: the
same launch, token and plain-version checks as in the whole script. The
children's output goes to `--log`. Prints one line ``AB <tree> <arch>
{json}`` a path and run: prefill ms, decode ms a step (wall and in the
policy step), device busy ms a prefill and a step, device operations a
step, the idle share and peak GB; then, per arch, each tree's runs side by
side. Needs CUDA.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

KEYS = ("prefill_ms", "decode_ms_per_step", "policy_step_ms", "prefill_busy_ms",
        "decode_busy_ms", "decode_device_ops_per_step", "decode_idle_share", "peak_gb")

CHILD = """
import json, sys
from pathlib import Path
root = Path(sys.argv[1]).resolve()
sys.path[:0] = [str(root / "src"), str(root)]
import torch
import chip_smoke
import repro_torch
from repro_torch.kernels import build
assert Path(repro_torch.__file__).resolve().is_relative_to(root), repro_torch.__file__
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.build()
for arch in (sys.argv[2:] or list(chip_smoke.SERVE)):
    _, m = chip_smoke.serve_phase(arch)
    torch.cuda.empty_cache()
    m = dict(m, prefill_busy_ms=m["prefill_device_ms"]["busy"],
             decode_busy_ms=m["decode_device_ms_per_step"]["busy"])
    print("AB", json.dumps({"arch": arch, **{k: m[k] for k in %r}}), flush=True)
""" % (KEYS,)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True, help="a checkout's root")
    ap.add_argument("--arch", action="append", default=[])
    ap.add_argument("--log", default="build/serve_ab.log")
    args = ap.parse_args()
    log = Path(args.log)
    log.parent.mkdir(parents=True, exist_ok=True)
    runs = []
    with open(log, "w") as f:
        for tree in args.tree:
            f.write(f"==== {tree}\n")
            f.flush()
            child = subprocess.run([sys.executable, "-c", CHILD, tree, *args.arch],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            f.write(child.stdout)
            f.flush()
            if child.returncode != 0:
                print(child.stdout[-3000:])
                raise SystemExit(f"serve_ab: the run of {tree} exited {child.returncode}")
            for line in child.stdout.splitlines():
                if line.startswith("AB "):
                    row = json.loads(line[3:])
                    runs.append((tree, row))
                    print(f"AB {tree} {row['arch']} {json.dumps(row)}", flush=True)
    for arch in dict.fromkeys(row["arch"] for _, row in runs):
        print(f"== {arch}")
        for key in KEYS:
            cells = [f"{tree}: {row[key]:.4f}" for tree, row in runs if row["arch"] == arch]
            print(f"   {key}: {'; '.join(cells)}")


if __name__ == "__main__":
    main()
