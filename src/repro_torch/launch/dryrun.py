"""Dry run: prove the distribution config is coherent, on a fake mesh.

The port's counterpart of ``repro.launch.dryrun``. For an (architecture x
input shape) cell on the production mesh (16 x 16 = 256 ranks, or 2 x 16 x
16 = 512 with ``--multi-pod``) it builds the port's model on the meta
device, distributes the step's inputs by the rules (``launch.specs``), and
runs the real step (train step: forward, backward and AdamW; prefill; or
the serve step) eagerly under ``sharding_ctx`` on one rank of a ``fake``
process group, where collectives move nothing and meta tensors hold
shapes only. Meta tensors take the kernels' plain versions. The report
(``launch.analysis``) holds one rank's FLOPs, bytes, collective bytes,
memory and the roofline terms modelled from the H100's spec.

A process holds one default process group, so a dry run runs in a process
of its own (this CLI, or a child process in tests and ``chip_smoke.py``).
It needs no card.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out FILE]

Reports are appended to ``--out`` (default ``build/dryrun_torch.jsonl``).
"""

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs.registry import ARCHS, get_config, make_model
from repro_torch.configs.shapes import SHAPES, shape_cells
from repro_torch.core.losses import make_train_step
from repro_torch.device import dtype_of
from repro_torch.hw import H100_SXM
from repro_torch.launch.analysis import analyze_step, local_bytes
from repro_torch.launch.mesh import init_fake_group, make_production_mesh
from repro_torch.launch.op_cost import OpCounter
from repro_torch.launch.serve import make_prefill, make_serve_step
from repro_torch.launch.specs import (batch_specs, cache_specs, params_specs, rules_for,
                                      state_specs)
from repro_torch.optim import adamw
from repro_torch.sharding.ctx import sharding_ctx
from repro_torch.sharding.rules import mesh_sizes

DEFAULT_OUT = os.path.join("build", "dryrun_torch.jsonl")


def production_config(arch, mesh, kind="train"):
    """The config a cell runs: tp from the mesh's 'model' axis (heads and
    vocab padded to it), bf16 params and compute, full remat; pure-DP
    configs train with tp 1 and no gradient accumulation."""
    cfg = get_config(arch)
    tp = mesh_sizes(mesh).get("model", 1)
    if cfg.pure_dp and kind == "train":
        tp = 1
        cfg = cfg.with_(grad_accum=1)
    return cfg.with_(tp=tp, param_dtype="bfloat16", compute_dtype="bfloat16",
                     remat=cfg.remat if cfg.remat != "none" else "full")


def cell_rules(cfg, mesh, kind):
    """rules_for, with serving's "full EP" for an MoE decode: one expert
    slice a rank over model x data, so decode moves the tokens, not the
    expert weights."""
    rules = rules_for(cfg, mesh, kind)
    if kind == "decode" and cfg.family == "moe":
        names = mesh_sizes(mesh)
        rules = dict(rules, experts=tuple(a for a in ("model", "data") if a in names))
    return rules


def lower_cell(arch: str, shape_name: str, mesh, verbose=False, shape=None):
    """Run one (arch x shape) cell's step on `mesh`'s meta shards. Returns
    the report (``analysis.analyze_step``'s keys and the cell's)."""
    shape = shape or SHAPES[shape_name]
    cfg = production_config(arch, mesh, shape.kind)
    bundle = make_model(cfg)
    rules = cell_rules(cfg, mesh, shape.kind)
    n_chips = mesh.size()
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    with sharding_ctx(mesh, rules):
        if shape.kind == "train":
            opt = adamw(1e-4, moment_dtype=dtype_of(cfg.optimizer_dtype))
            step = make_train_step(bundle, opt)
            state = state_specs(bundle, opt, mesh, cfg)
            batch = batch_specs(cfg, shape, mesh, rules)
            args = local_bytes(state["params"]) + local_bytes(state["opt_state"]) \
                + local_bytes(batch)
            t_setup = time.perf_counter() - t0
            with OpCounter() as counter:
                state, _ = step(state, batch)
            # the state is updated in place (the reference donates it)
            out = alias = local_bytes(state["params"]) + local_bytes(state["opt_state"])
        elif shape.kind == "prefill":
            params = params_specs(bundle, mesh, rules)
            batch = batch_specs(cfg, shape, mesh, rules, with_rl_fields=False)
            args = local_bytes(params) + local_bytes(batch)
            t_setup = time.perf_counter() - t0
            with OpCounter() as counter:
                tok, cache = make_prefill(bundle, shape.seq_len, bf16)(params, batch)
            out, alias = local_bytes(cache) + local_bytes(tok), 0
        else:   # decode
            params = params_specs(bundle, mesh, rules)
            cache = cache_specs(bundle, shape, mesh, rules)
            tok = torch.zeros((shape.global_batch, 1), dtype=torch.int32, device="meta")
            args = local_bytes(params) + local_bytes(cache) + local_bytes(tok)
            t_setup = time.perf_counter() - t0
            with OpCounter() as counter:
                tok, cache = make_serve_step(bundle)(params, tok, cache)
            # the cache is written in place (the reference donates it)
            out = alias = local_bytes(cache)
            out += local_bytes(tok)
    t_step = time.perf_counter() - t0 - t_setup
    rep = analyze_step(counter.report(), argument_bytes=args, output_bytes=out,
                       alias_bytes=alias, n_chips=n_chips, chip=H100_SXM)
    sizes = mesh_sizes(mesh)
    rep.update(arch=arch, shape=shape_name, mesh=list(sizes.values()),
               mesh_axes=list(sizes), n_chips=n_chips, setup_s=round(t_setup, 1),
               step_s=round(t_step, 1))
    if verbose:
        mem, t = rep["memory"], rep["terms"]
        print(f"[{arch} x {shape_name} x {'x'.join(map(str, sizes.values()))}] "
              f"flops/rank={rep['flops_per_chip']:.3e} "
              f"hbm B/rank={rep['hbm_bytes_per_chip']:.3e} "
              f"coll B/rank={rep['collective_bytes_per_chip']:.3e} | modelled on "
              f"{H100_SXM.name}: compute={t.compute_s * 1e3:.2f}ms "
              f"memory={t.memory_s * 1e3:.2f}ms collective={t.collective_s * 1e3:.2f}ms "
              f"-> {t.dominant()}-bound | mem/rank={mem['total_bytes'] / 1e9:.2f} GB "
              f"(args {mem['argument_bytes'] / 1e9:.2f} + temp {mem['temp_bytes'] / 1e9:.2f}"
              f" - alias {mem['alias_bytes'] / 1e9:.2f}) | {rep['step_s']} s", flush=True)
    return rep


def serialize(rep):
    """The report as JSON: the terms as a dict with their dominant one."""
    rep = dict(rep)
    t = rep.pop("terms")
    rep["terms"] = {"compute_s": t.compute_s, "memory_s": t.memory_s,
                    "collective_s": t.collective_s, "dominant": t.dominant(),
                    "modelled_on": H100_SXM.name}
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT, help="append JSONL reports here")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch, s) for arch in ARCHS for s in shape_cells(arch)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]
    init_fake_group(512 if args.multi_pod else 256)
    mesh = make_production_mesh(multi_pod=args.multi_pod)
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    failures = []
    for arch, s in cells:
        try:
            rep = lower_cell(arch, s, mesh, verbose=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(serialize(rep)) + "\n")
        except Exception as e:  # noqa: BLE001 — report and continue
            traceback.print_exc()
            failures.append((arch, s, repr(e)))
    if failures:
        print(f"\nFAILED {len(failures)}/{len(cells)} cells:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print(f"\nOK: {len(cells)} cells run on meta shards of the fake mesh {mesh_sizes(mesh)}")


if __name__ == "__main__":
    main()
