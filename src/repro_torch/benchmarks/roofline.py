"""Roofline table: each (arch x shape) cell's terms from the port's dry-run
JSONL, with MODEL_FLOPS = 6·N·D (or 6·N_active·D) and the useful-compute
ratio.

The port's counterpart of ``benchmarks/roofline.py``: ``model_flops`` and
``rows`` are the reference's, read over ``launch.dryrun``'s reports
(default ``build/dryrun_torch.jsonl``), with the H100's published bf16
peak (``hw.H100_SXM``) in place of the TPU's. Every term is modelled from
the card's spec, not measured.

    PYTHONPATH=src python -m repro_torch.benchmarks.roofline [--path FILE]
"""

import argparse
import json
import os

from repro_torch.configs.base import active_param_count, param_count
from repro_torch.configs.registry import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.hw import H100_SXM
from repro_torch.launch.dryrun import DEFAULT_OUT


def model_flops(cfg, shape):
    n = active_param_count(cfg) if cfg.family == "moe" else param_count(cfg)
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n * d
    return 2.0 * n * shape.global_batch          # decode: one token per seq


def rows(path):
    for line in open(path):
        r = json.loads(line)
        cfg = get_config(r["arch"])
        shape = SHAPES[r["shape"]]
        t = r["terms"]
        bound = max(t["compute_s"], t["memory_s"], t["collective_s"])
        mf = model_flops(cfg, shape)
        counted = r["flops_per_chip"] * r["n_chips"]
        ratio = mf / counted if counted else 0.0
        # roofline fraction: useful model FLOPs per second vs peak, the step
        # time lower-bounded by the dominant term (perfect overlap)
        mfu = mf / (r["n_chips"] * H100_SXM.peak_bf16_flops * bound) if bound else 0.0
        yield {
            "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
            "compute_s": t["compute_s"], "memory_s": t["memory_s"],
            "collective_s": t["collective_s"], "dominant": t["dominant"],
            "model_flops": mf, "counted_flops": counted, "useful_ratio": ratio,
            "roofline_frac": mfu, "mem_gb": r["memory"]["total_bytes"] / 1e9,
        }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", default=DEFAULT_OUT, help="the dry run's JSONL")
    args = ap.parse_args(argv)
    print("name,value,derived")
    if not os.path.exists(args.path):
        print(f"roofline_table,0,missing {args.path} — run `python -m "
              f"repro_torch.launch.dryrun --all --out {args.path}`")
        return
    for r in rows(args.path):
        print(f"roofline_{r['arch']}_{r['shape']},{r['roofline_frac']:.4f},"
              f"dominant={r['dominant']} compute={r['compute_s'] * 1e3:.1f}ms "
              f"memory={r['memory_s'] * 1e3:.1f}ms "
              f"collective={r['collective_s'] * 1e3:.1f}ms "
              f"useful_ratio={r['useful_ratio']:.3f} mem={r['mem_gb']:.1f}GB "
              f"modelled_on={H100_SXM.name}")


if __name__ == "__main__":
    main()
