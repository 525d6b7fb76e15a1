#!/usr/bin/env python3
"""The training path's gradient leaves (recurrentgemma-2b at 3 layers of full
width, fp32) against K1 and K4 taken in fp64, at several batches, for one
checkout of the port, on one GPU: the witness for the fp64 check of
``chip_smoke.train_parity_phase``.

    PYTHONPATH=<checkout>/src python3 tools/train_parity_fp64.py [--tag NAME] [--batches N]

The port comes from PYTHONPATH when it names another checkout's ``src``
(so two trees compare in one call), else from this checkout; the check's
functions come from this checkout's ``chip_smoke.py``. For each of the
first N batches of the launcher's data, the V-trace loss's gradient leaves
are taken with K1 and K4 (each with its backward kernel) in four ways:
through the plain fp32 versions (``chip_smoke.plain_versions``), through
all the kernels, through K1's alone (K4 plain), and through K4's alone (K1
plain). Each is held against the leaves with K1 and K4 in fp64
(``chip_smoke.fp64_versions``; the rest of the model in fp32) by
``chip_smoke.leaf_distances``: a leaf's largest ``|g - g64| / (GRAD_TOL
(max |g64| + |g64|))``, above 1 beyond GRAD_TOL of its max. Prints, per
batch and way, the farthest leaf, the leaf nearest to the check's limit
(``chip_smoke.fp64_verdict``: max(1, FP64_MARGIN x plain fp32's
distance)), the leaves beyond it, and the largest distance of any way from
the plain fp32 leaves (the check this one replaced). Needs CUDA.
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
from repro_torch.core.losses import make_vtrace_loss, param_grads  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="")
    ap.add_argument("--batches", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_parity_fp64: needs a CUDA device", file=sys.stderr)
        return 2
    card = chip_smoke.card_identity()
    print(f"card: {card}; repro_torch from {Path(ops.__file__).parents[2]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    b, s = chip_smoke.TRAIN["batch"], chip_smoke.TRAIN["seq"]
    run = train.setup(chip_smoke.TRAIN["arch"], batch=b, seq=s, steps=1, device="cuda",
                      num_layers=3)
    params = run.make_state()["params"]
    chip_smoke.live_table(params, run.cfg)
    named = dict(params.named_parameters())
    loss_fn = make_vtrace_loss(run.bundle)
    ways = {"all_kernels": dict(k1=False, k4=False), "k1_alone": dict(k1=False, k4=True),
            "k4_alone": dict(k1=True, k4=False)}

    for i in range(args.batches):
        batch = run.batch_at(i)
        with chip_smoke.fp64_versions(ops):
            ref = param_grads(loss_fn(params, batch)[0], named)
        with chip_smoke.plain_versions(ops):
            plain = param_grads(loss_fn(params, batch)[0], named)
        far = max((d, n) for n, d in chip_smoke.leaf_distances(plain, ref).items())
        row = {"tag": args.tag, "batch": i,
               "largest_max_abs_grad": max(float(r.abs().max()) for r in ref.values()),
               "plain_fp32": {"farthest_from_fp64": far}}
        for name, swap in ways.items():
            with chip_smoke.plain_versions(ops, **swap):
                got = param_grads(loss_fn(params, batch)[0], named)
            verdict = chip_smoke.fp64_verdict(got, plain, ref)
            row[name] = {"farthest_from_fp64": verdict["farthest"],
                         "nearest_to_limit": verdict["nearest"], "failed": verdict["failed"],
                         "farthest_from_plain_fp32": max(
                             (d, n) for n, d in chip_smoke.leaf_distances(got, plain).items())}
            del got
        print(json.dumps(row), flush=True)
        del ref, plain
    print(json.dumps({"card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
