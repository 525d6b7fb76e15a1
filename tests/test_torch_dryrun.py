"""The port's dry run (``launch/dryrun.py``) and roofline on fake meshes.

Each dry run holds a process group of its own, so each runs in a child
process; no card is needed.

- The reference test's reduced cell (``tests/test_distributed.py``:
  internvl2-1b ``train_4k`` at batch 8 and seq 512, on a (2, 4) mesh of
  ("data", "model")) and the same config's prefill cell, on a fake group
  of 8 ranks: FLOPs a rank above 0, the dominant term one of the three,
  and the argument bytes a rank (params, AdamW moments and the batch;
  params and the batch for the prefill) equal to the reference's sharded
  bytes, computed from its own specs (``jax.eval_shape`` and ``safe_spec``
  on an abstract mesh; the reference's step counter, a 4-byte int32, is a
  host int in the port).
- Both cells' FLOPs a rank against the reference's ``module_costs`` of the
  compiled step on 8 virtual devices, within 2.5%. The gap is the k and v
  projections: XLA's SPMD partitioner lets each rank compute only the kv
  heads its query heads read (the expansion to the padded heads lets it
  shard them over 'model'), where the port computes every kv head on every
  rank and slices them in the attention call (``kv_for_heads``): at the
  prefill cell that is half of the two projections, +2.1%.
- ``python -m repro_torch.launch.dryrun --arch qwen3-14b --shape
  decode_32k`` on the fake (16, 16) mesh of 256 ranks, then the port's
  roofline over its JSONL, with terms modelled on ``H100_SXM``.
"""

import json
import math
import os
import subprocess
import sys
import textwrap
from dataclasses import replace

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import make_model as jmake_model  # noqa: E402
from repro.configs.shapes import SHAPES as JSHAPES  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.sharding.param import decode_axes  # noqa: E402
from repro.sharding.rules import safe_spec as jsafe_spec  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCH, CELLS = "internvl2-1b", ("train_4k", "prefill_32k")
BATCH, SEQ = 8, 512            # seq must exceed internvl's 256 frontend tokens
FLOPS_TOL = 0.025


def _run(code, env=None, timeout=600):
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                         text=True, timeout=timeout,
                         env=dict(os.environ, PYTHONPATH=SRC, **(env or {})))
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def _result(stdout):
    return json.loads([x for x in stdout.splitlines() if x.startswith("RESULT ")][-1][7:])


@pytest.fixture(scope="module")
def reports():
    """The port's two reports on the fake (2, 4) mesh and the reference's
    FLOPs a rank of the same cells on 8 virtual devices."""
    port = _result(_run(f"""
        import json
        from dataclasses import replace
        from repro_torch.configs.shapes import SHAPES
        from repro_torch.launch.dryrun import lower_cell, serialize
        from repro_torch.launch.mesh import init_fake_group, make_mesh
        init_fake_group(8)
        mesh = make_mesh((2, 4), ("data", "model"))
        out = {{s: serialize(lower_cell("{ARCH}", s, mesh, shape=replace(
            SHAPES[s], global_batch={BATCH}, seq_len={SEQ}))) for s in {CELLS!r}}}
        # one sharded matmul, then its output gathered, then a partial sum
        # reduced: what OpCounter counts for a rank
        import torch
        from torch.distributed.tensor import Partial, Replicate, Shard
        from repro_torch.launch.op_cost import OpCounter
        from repro_torch.sharding.param import shard_tensor
        x = shard_tensor(torch.empty(8, 64, 96, device="meta", dtype=torch.bfloat16), mesh,
                         (Shard(0), Replicate()))
        w = shard_tensor(torch.empty(96, 128, device="meta", dtype=torch.bfloat16), mesh,
                         (Replicate(), Shard(1)))
        with OpCounter() as oc:
            y = x @ w
            y.redistribute(mesh, (Shard(0), Replicate()))
        with OpCounter() as oc2:
            (y @ w.redistribute(mesh, (Replicate(), Replicate())).t()).redistribute(
                mesh, (Shard(0), Replicate()))
        out["op_counter"] = {{"mm": oc.report(), "partial": oc2.report()}}
        print("RESULT " + json.dumps(out))
    """))
    ref = _result(_run(f"""
        import json
        from dataclasses import replace
        from repro.configs import SHAPES
        from repro.launch.dryrun import lower_cell
        from repro.launch.mesh import make_mesh
        mesh = make_mesh((2, 4), ("data", "model"))
        out = {{}}
        for s in {CELLS!r}:
            SHAPES[s] = replace(SHAPES[s], global_batch={BATCH}, seq_len={SEQ})
            out[s] = lower_cell("{ARCH}", s, mesh)["flops_per_chip"]
        print("RESULT " + json.dumps(out))
    """, env={"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
              "JAX_PLATFORMS": "cpu"}))
    return port, ref


def _ref_argument_bytes(shape_name):
    """Params (+ AdamW moments for train) + the batch, bytes a rank under
    the reference's own specs on an abstract (2, 4) mesh."""
    mesh = AbstractMesh((2, 4), ("data", "model"))
    sizes = {"data": 2, "model": 4}
    shape = replace(JSHAPES[shape_name], global_batch=BATCH, seq_len=SEQ)
    cfg = jget_config(ARCH)
    tp = 1 if (cfg.pure_dp and shape.kind == "train") else 4
    cfg = cfg.with_(tp=tp, param_dtype="bfloat16", compute_dtype="bfloat16",
                    remat=cfg.remat if cfg.remat != "none" else "full",
                    **({"grad_accum": 1} if cfg.pure_dp and shape.kind == "train" else {}))
    bundle = jmake_model(cfg)
    rules = jspecs.rules_for(cfg, mesh, shape.kind)

    def local(shape_, dtype, spec):
        n = 1
        for i, dim in enumerate(shape_):
            e = spec[i] if i < len(spec) else None
            div = math.prod(sizes[a] for a in ((e,) if isinstance(e, str) else (e or ())))
            n *= dim // div
        return n * jnp.dtype(dtype).itemsize

    params = jax.tree.leaves(jax.eval_shape(bundle.init, jax.random.PRNGKey(0)))
    axes = [decode_axes(a) for a in jax.tree.leaves(bundle.logical_axes())]
    total = sum(local(p.shape, p.dtype, jsafe_spec(p.shape, a, rules, mesh))
                for p, a in zip(params, axes))
    if shape.kind == "train":
        o_rules = jspecs.opt_rules_for(cfg, mesh)
        total += 2 * sum(local(p.shape, jnp.dtype(cfg.optimizer_dtype),
                               jsafe_spec(p.shape, a, o_rules, mesh))
                         for p, a in zip(params, axes))
    f = cfg.frontend_tokens
    fields = [((BATCH, SEQ - f), jnp.int32)]
    if shape.kind == "train":
        fields += [((BATCH, SEQ - f), jnp.float32)] * 4
    fields += [((BATCH, f, cfg.frontend_dim), jnp.bfloat16)]
    for shp, dt in fields:
        axes_ = ("act_batch",) + (None,) * (len(shp) - 1)
        total += local(shp, dt, jsafe_spec(shp, axes_, rules, mesh))
    return total


@pytest.mark.parametrize("shape_name", CELLS)
def test_dryrun_cell_on_a_fake_mesh_matches_jax(reports, shape_name):
    port, ref = reports
    rep = port[shape_name]
    assert rep["n_chips"] == 8 and rep["mesh"] == [2, 4]
    assert rep["flops_per_chip"] > 0
    assert rep["terms"]["dominant"] in ("compute", "memory", "collective")
    assert rep["terms"]["modelled_on"] == "h100-sxm5-80gb"
    assert rep["memory"]["argument_bytes"] == _ref_argument_bytes(shape_name)
    assert abs(rep["flops_per_chip"] / ref[shape_name] - 1) <= FLOPS_TOL, \
        (rep["flops_per_chip"], ref[shape_name])


def test_dryrun_cli_on_256_ranks_and_roofline(tmp_path):
    out = tmp_path / "dryrun.jsonl"
    log = _run(f"""
        from repro_torch.launch import dryrun
        dryrun.main(["--arch", "qwen3-14b", "--shape", "decode_32k", "--out", "{out}"])
        from repro_torch.benchmarks import roofline
        roofline.main(["--path", "{out}"])
    """)
    assert "OK: 1 cells" in log and "{'data': 16, 'model': 16}" in log
    row = json.loads(out.read_text().splitlines()[-1])
    assert row["n_chips"] == 256 and row["mesh"] == [16, 16] and row["flops_per_chip"] > 0
    line = [x for x in log.splitlines() if x.startswith("roofline_qwen3-14b_decode_32k,")]
    assert line and "modelled_on=h100-sxm5-80gb" in line[0], log[-2000:]
    assert np.isfinite(row["terms"]["memory_s"]) and row["terms"]["memory_s"] > 0


def test_op_counter_counts_one_ranks_work(reports):
    """On the fake (2, 4) mesh: x (8, 64, 96) over 'data' times w (96, 128)
    over 'model' costs a rank 2 * 4 * 64 * 96 * 32 FLOPs (a quarter of
    w's columns, half the batch), not the global product's; gathering y
    (8, 64, 128) bf16 over 'model' counts its gathered output a rank,
    4 * 64 * 128 * 2 bytes; reducing a partial sum of y @ w^T, (4, 64, 96)
    bf16 a rank, counts twice its tensor (the ring's all-reduce)."""
    port, _ = reports
    mm, partial = port["op_counter"]["mm"], port["op_counter"]["partial"]
    assert mm["flops"] == 2 * 4 * 64 * 96 * 32 == mm["flops_by_op"]["mm"]
    assert mm["collectives"] == {"all-gather": 4 * 64 * 128 * 2}
    assert mm["collective_count"] == 1
    assert partial["collectives"]["all-reduce"] == 2 * 4 * 64 * 96 * 2


def test_roofline_model_flops_match_the_reference():
    """The port's roofline counts the reference's MODEL_FLOPS (6 N D, or 2 N
    a token in serving) for every arch and shape, exactly (the reference's
    script, loaded by path)."""
    import importlib.util
    from repro_torch.benchmarks import roofline
    from repro_torch.configs.registry import ARCHS, get_config
    from repro_torch.configs.shapes import SHAPES
    spec = importlib.util.spec_from_file_location(
        "jroofline", os.path.join(os.path.dirname(__file__), "..", "benchmarks", "roofline.py"))
    jroofline = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jroofline)
    for arch in ARCHS:
        for name, shape in SHAPES.items():
            assert roofline.model_flops(get_config(arch), shape) == \
                jroofline.model_flops(jget_config(arch), JSHAPES[name]), (arch, name)
