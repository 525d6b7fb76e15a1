"""The port's sharding against the JAX package's, on the CPU.

- Rules: ``sharding/rules.py``'s tables, ``logical_to_spec`` and
  ``safe_spec``, and ``launch/specs.py``'s ``rules_for`` and
  ``opt_rules_for``, against the reference's on ``jax.sharding.AbstractMesh``
  (16, 16) and (2, 16, 16), for every LM arch at its production config
  (``launch.dryrun.production_config``) for train, prefill and decode: the
  rule tables, each parameter's logical axes (``logical_axes`` of the port's
  model on the meta device, by converted name, against
  ``bundle.logical_axes()``), its spec and its bytes a rank. Shapes only:
  ``jax.eval_shape`` and the meta device, no weights. Exact equality.
- ``cache_specs``: every decode-cache leaf's logical axes against the
  reference's ``_cache_leaf_axes``.
- Padded heads (tp > 1): qwen3-14b's and recurrentgemma-2b's reduced
  configs with 6 query heads over 2 kv heads at tp 4 (padded to 8 heads, a
  group of 4 where the unpadded group is 3; vocab 277 padded to 512):
  forward, prefill and decode logits against the reference on converted
  params, 1e-4 (fp32 both sides, as tests/test_torch_lm.py); random values
  in the padded rows of wq and wo leave both packages' logits unchanged,
  bit for bit. The padded model is not the unpadded one: padding changes
  which kv head a query head reads (``jnp.repeat(k, hp // k_heads)``,
  ``src/repro/nn/attention.py:95,174``), so only the padded heads' own
  contribution is exactly zero.
- ``moe_ep`` and ``reshard_state`` on a 4-rank gloo group (four spawned
  processes over a file store; two tests): ``moe_ep`` against the
  reference's ``moe`` at 1e-5 (experts over 'model' and over ('model',
  'data')) and its gradients against the port's gather-only dispatch at
  1e-5 of each one's max; a tp-2 train state restored bit-exact onto a
  (2, 2) mesh, whose sharded forward then gives the unsharded logits
  within 1e-5 (partial sums meet in another order); ``shard_batch`` lays
  a batch out by the reference's 'act_batch' (and a sequence axis's) spec.
"""

import functools
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import make_model as jmake_model  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke_config  # noqa: E402
from repro.launch.serve import greedy_generate as jgreedy  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro.sharding.param import decode_axes  # noqa: E402
from repro_torch.configs.registry import ARCHS, make_model, smoke_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.dryrun import production_config  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.sharding.param import logical_axes  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
KINDS = ("train", "prefill", "decode")
KIND_SHAPE = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}


def _jspec(p):
    """A PartitionSpec as the port's spec tuple."""
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in p)


def _jproduction_config(arch, sizes, kind):
    """The reference's ``launch.dryrun.production_config`` (whose module
    forces XLA's device count on import) over a mesh's sizes."""
    cfg = jget_config(arch)
    tp = sizes.get("model", 1)
    if cfg.pure_dp and kind == "train":
        tp = 1
        cfg = cfg.with_(grad_accum=1)
    return cfg.with_(tp=tp, param_dtype="bfloat16", compute_dtype="bfloat16",
                     remat=cfg.remat if cfg.remat != "none" else "full")


def test_rule_tables_match():
    for name in ("DEFAULT_RULES", "FSDP_RULES", "FSDP_POD_RULES", "REPLICATED_RULES"):
        assert dict(getattr(rules, name)) == dict(getattr(jrules, name)), name
    assert set(ARCHS) == set(JARCHS) and len(ARCHS) == 10
    axes = ("act_batch", "embed", None, "experts", "heads", "mlp", "vocab")
    for table in (rules.DEFAULT_RULES, rules.FSDP_POD_RULES):
        for n in range(len(axes) + 1):
            got = rules.logical_to_spec(axes[:n] + ("act_heads",), table)
            assert got == _jspec(jrules.logical_to_spec(axes[:n] + ("act_heads",), table))


@functools.lru_cache(maxsize=None)
def _models(arch, kind, tp):
    """(reference param shapes and axes by the port's names, the port's
    meta model) at the production config for `kind` on a 'model' axis of
    `tp`: every reference leaf numbered and carried through
    ``params_from_jax``, layer by layer, to find its port name."""
    jcfg = _jproduction_config(arch, {"model": tp}, kind)
    cfg = production_config(arch, rules.AbstractMesh((tp,), ("model",)), kind)
    assert cfg == cfg.with_(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    jbundle = jmake_model(jcfg)
    shapes = jax.eval_shape(jbundle.init, jax.random.PRNGKey(0))
    axes = jbundle.logical_axes()
    leaves, tree = jax.tree.flatten(shapes)
    jaxes = jax.tree.leaves(axes)
    stacked = [decode_axes(a)[:1] == ("layers",) for a in jaxes]
    ids = tree.unflatten([np.arange(x.shape[0]) + (i << 20) if st else np.array(i << 20)
                          for i, (x, st) in enumerate(zip(leaves, stacked))])
    ref = {}
    for name, t in params_from_jax(cfg, ids).items():
        i = int(t.reshape(-1)[0]) >> 20
        ax, sh = decode_axes(jaxes[i]), tuple(leaves[i].shape)
        if stacked[i]:
            ax, sh = ax[1:], sh[1:]
        ref[name] = (sh, ax, jnp.dtype(leaves[i].dtype).itemsize)
    return ref, make_model(cfg).init(0, device="meta")


def _jlocal_bytes(shape, spec, sizes, itemsize):
    n = 1
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        div = math.prod(sizes[a] for a in rules.spec_axes(entry))
        assert dim % div == 0
        n *= dim // div
    return n * itemsize


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_axes_and_specs_match_jax(arch, mesh_name, kind):
    """rules_for and opt_rules_for, then every parameter's logical axes,
    spec and bytes a rank, against the reference's on the same abstract
    mesh. A cell's model is built once on the meta device and once by
    jax.eval_shape."""
    shape, names = MESHES[mesh_name]
    jmesh, mesh = AbstractMesh(shape, names), rules.AbstractMesh(shape, names)
    sizes = dict(zip(names, shape))
    cfg = production_config(arch, mesh, kind)
    jcfg = _jproduction_config(arch, sizes, kind)
    r, jr = specs.rules_for(cfg, mesh, kind), jspecs.rules_for(jcfg, jmesh, kind)
    assert dict(r) == dict(jr)
    o, jo = specs.opt_rules_for(cfg, mesh), jspecs.opt_rules_for(jcfg, jmesh)
    assert dict(o) == dict(jo)
    ref, model = _models(arch, kind, cfg.tp)
    got = logical_axes(model)
    assert set(got) == set(ref)
    for name, p in model.named_parameters():
        jshape, jax_axes, itemsize = ref[name]
        assert tuple(p.shape) == jshape and got[name] == jax_axes, name
        assert p.element_size() == itemsize, name
        for table, jtable in ((r, jr), (o, jo)):
            spec = rules.safe_spec(p.shape, got[name], table, mesh)
            jspec_ = _jspec(jrules.safe_spec(jshape, jax_axes, jtable, jmesh))
            assert spec == jspec_, (name, spec, jspec_)
            local = math.prod(rules.local_shape(p.shape, spec, mesh)) * p.element_size()
            assert local == _jlocal_bytes(jshape, jspec_, sizes, itemsize), name


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_leaf_axes_match_jax(arch):
    """Each leaf of the port's decode cache (one entry a layer) gets the
    reference's ``_cache_leaf_axes`` of the same leaf unstacked, and the
    leaves' (shape, axes) counted over the layers equal the reference's
    stacked cache's with its layer axis dropped."""
    from collections import Counter
    cfg = smoke_config(arch)
    shape = SHAPES["decode_32k"].__class__("small", 64, 4, "decode")
    port = specs.cache_axes(make_model(cfg), shape)
    got = Counter()
    for ks, sh, axes in port:
        x = jax.ShapeDtypeStruct(sh, jnp.int32 if ks.endswith("['pos']") or ks == "['index']"
                                 else jnp.bfloat16)
        assert axes == jspecs._cache_leaf_axes("['rest']" + ks, x), ks
        got[(sh, axes)] += 1
    jbundle = jmake_model(jsmoke_config(arch))
    sds = jax.eval_shape(lambda: jbundle.init_cache(shape.global_batch, shape.seq_len,
                                                    jnp.bfloat16))
    want = Counter()
    for path, x in jax.tree_util.tree_flatten_with_path(sds)[0]:
        ks = jax.tree_util.keystr(path)
        axes = jspecs._cache_leaf_axes(ks, x)
        if "rest" not in ks and x.ndim >= 1 and "index" not in ks:
            want[(tuple(x.shape[1:]), axes[1:])] += x.shape[0]
        else:
            want[(tuple(x.shape), axes)] += 1
    assert got == want


# ------------------------------------------------------------- padded heads

PADDED = dict(num_heads=6, num_kv_heads=2, tp=4)
B, S, MAX_LEN, STEPS = 2, 12, 32, 4


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", ["qwen3-14b", "recurrentgemma-2b"])
def test_padded_heads_match_jax_and_padding_is_inert(arch):
    jcfg = jsmoke_config(arch).with_(**PADDED)
    cfg = smoke_config(arch).with_(**PADDED)
    assert cfg.padded_heads == jcfg.padded_heads == 8 and cfg.padded_vocab == 512
    jbundle, bundle = jmake_model(jcfg), make_model(cfg)
    jparams = jbundle.init(jax.random.PRNGKey(0))
    params = bundle.init(0, device="cpu")
    params.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))

    def run_jax(jp):
        out = [jbundle.forward(jp, {"tokens": jnp.asarray(tokens, jnp.int32)}).logits]
        o, cache = jbundle.prefill(jp, {"tokens": jnp.asarray(tokens, jnp.int32)}, MAX_LEN,
                                   jnp.float32)
        out.append(o.logits)
        tok = jnp.argmax(o.logits[:, -1], -1)[:, None].astype(jnp.int32)
        for _ in range(STEPS):
            o, cache = jbundle.decode_step(jp, tok, cache)
            out.append(o.logits)
            tok = jnp.argmax(o.logits[:, -1], -1)[:, None].astype(jnp.int32)
        return [np.asarray(x) for x in out]

    def run_port(p):
        with torch.no_grad():
            out = [bundle.forward(p, {"tokens": torch.from_numpy(tokens)}).logits]
            o, cache = bundle.prefill(p, {"tokens": torch.from_numpy(tokens)}, MAX_LEN,
                                      torch.float32)
            out.append(o.logits)
            for i in range(STEPS):
                # fed the reference's greedy tokens, so both paths stay together
                tok = torch.from_numpy(np.argmax(want[1 + i][:, -1], -1)[:, None])
                o, cache = bundle.decode_step(p, tok, cache)
                out.append(o.logits)
        return out

    want = run_jax(jparams)
    got = run_port(params)
    for g, w in zip(got, want):
        _close(g, w)
    # random values in the padded heads' rows change nothing, in either package
    rng = np.random.default_rng(2)

    def scramble(leaf, axis):
        a = np.array(leaf)
        idx = [slice(None)] * a.ndim
        idx[axis] = slice(cfg.num_heads, None)
        a[tuple(idx)] = rng.standard_normal(a[tuple(idx)].shape).astype(a.dtype)
        return jnp.asarray(a)
    jscr = jax.tree_util.tree_map_with_path(
        lambda path, x: scramble(x, x.ndim - 2) if jax.tree_util.keystr(path).endswith("['wq']")
        else scramble(x, x.ndim - 3) if jax.tree_util.keystr(path).endswith("['wo']")
        and x.ndim >= 3 and x.shape[-3] == cfg.padded_heads else x, jparams)
    params.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jscr)))
    assert not np.array_equal(np.asarray(jscr["embed"]["table"]), 0)
    for g, w in zip(run_port(params), got):
        assert torch.equal(g, w)
    for g, w in zip(run_jax(jscr), want):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------ moe_ep and reshard_state

WORKER = textwrap.dedent('''
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    rank, world, store_path, what, data = sys.argv[1:6]
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.ctx import sharding_ctx
    from repro_torch.sharding.param import distribute_module, shard_tensor
    from repro_torch.sharding.rules import DEFAULT_RULES, filter_rules, placements, safe_spec
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {}
    if what == "moe_ep":
        from repro_torch.configs.base import ModelConfig
        from repro_torch.nn import moe
        z = np.load(data)
        cfg = ModelConfig(name="t", family="moe", num_layers=1, d_model=32, num_heads=4,
                          num_kv_heads=2, d_ff=64, vocab_size=64, num_experts=8,
                          num_experts_per_tok=2, moe_d_ff=16, n_shared_experts=1,
                          capacity_factor=8.0, tp=4)
        rules = filter_rules(DEFAULT_RULES, mesh)
        x_full = torch.from_numpy(z["x"])
        for name, table in (("model", rules), ("model_data", dict(rules, experts=("model", "data")))):
            p = moe.MoE(cfg)
            p.load_state_dict({k[2:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("p.")})
            plain = moe.MoE(cfg)
            plain.load_state_dict(p.state_dict())
            plain.requires_grad_(True)
            y0, _ = moe.moe(cfg.with_(moe_impl="gather"), plain, x_full)
            g0 = torch.autograd.grad(y0.sum(), list(plain.parameters()))
            distribute_module(p, mesh, table)
            p.requires_grad_(True)
            with sharding_ctx(mesh, table):
                x = shard_tensor(x_full, mesh, placements(
                    safe_spec(x_full.shape, ("act_batch", None, None), table, mesh), mesh))
                y, aux = moe.moe(cfg, p, x)
                g = torch.autograd.grad(y.sum(), list(p.parameters()))
            out[name] = {"y_err": float((y.full_tensor() - torch.from_numpy(z["y_ref"])).abs().max()),
                         "placement": str(p.wi.placements),
                         "grad_rel_err": max(float((a.full_tensor() - b).abs().max()
                                                   / b.abs().max().clamp(min=1e-30))
                                             for a, b in zip(g, g0))}
    elif what == "seq_decode":
        from repro_torch.configs.registry import make_model, smoke_config
        from repro_torch.launch.serve import greedy_generate
        from repro_torch.launch.specs import rules_for
        from repro_torch.sharding.rules import tree_leaves_with_keys
        spec = json.loads(open(data + ".json").read())
        for arch, (over, steps, max_len) in spec.items():
            z = np.load(f"{data}.{arch}.npz")
            cfg = smoke_config(arch).with_(**over)
            bundle = make_model(cfg)
            params = bundle.init(0, device="cpu")
            params.load_state_dict({k[2:]: torch.from_numpy(z[k]) for k in z.files
                                    if k.startswith("p.")})
            batch = {k: torch.from_numpy(z[k]) for k in ("tokens", "frontend") if k in z.files}
            with torch.no_grad():
                plain = greedy_generate(bundle, params, batch, steps, max_len, torch.float32)
                rules = rules_for(cfg, mesh, "decode")
                distribute_module(params, mesh, rules)
                with sharding_ctx(mesh, rules):
                    got = greedy_generate(bundle, params, batch, steps, max_len, torch.float32)
                    _, cache = bundle.prefill(params, batch, max_len, torch.float32)
            kv = {}
            for ks, leaf in tree_leaves_with_keys(cache):
                if ks.endswith(("['k']", "['v']", "['xk']", "['xv']")):
                    name = ks[ks.rindex("['") + 2:-2]
                    kv.setdefault(name, set()).add(str(tuple(leaf.placements)))
            out[arch] = {"plain": plain.tolist(), "sharded": got.tolist(),
                         "act_kv_seq": list(rules["act_kv_seq"]),
                         "cache": {k: sorted(v) for k, v in kv.items()}}
    else:
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.configs.registry import make_model, smoke_config
        from repro_torch.core.losses import init_train_state
        from repro_torch.launch.ft import reshard_state
        from repro_torch.launch.specs import rules_for
        from repro_torch.optim import adamw
        cfg = smoke_config("qwen3-14b").with_(tp=2)
        bundle, opt = make_model(cfg), adamw(1e-3)
        state = init_train_state(bundle, opt, 0, "cpu")
        mgr = CheckpointManager(data, async_save=False)
        if rank == 0:
            mgr.save(state, 5)
        dist.barrier()
        restored, step = reshard_state(mgr, bundle, opt, cfg, mesh)
        out["step"] = step
        leaves = [(n, p, dict(restored["params"].named_parameters())[n])
                  for n, p in state["params"].named_parameters()]
        leaves += [(f"{k}.{n}", t, restored["opt_state"][k][n])
                   for k, v in state["opt_state"].items() for n, t in v.items()]
        out["leaves"] = len(leaves)
        out["unequal"] = [n for n, a, b in leaves if not torch.equal(a.detach(), b.full_tensor())]
        from torch.distributed.tensor import Shard
        out["sharded"] = sum(any(isinstance(q, Shard) for q in b.placements)
                             for _, _, b in leaves)
        out["devices"] = sorted({b.to_local().device.type for _, _, b in leaves})
        tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (4, 16)))
        with torch.no_grad():
            want = bundle.forward(state["params"], {"tokens": tokens}).logits
            rules = rules_for(cfg, mesh, "train")
            with sharding_ctx(mesh, rules):
                tok = shard_tensor(tokens, mesh, placements(
                    safe_spec(tokens.shape, ("act_batch", None), rules, mesh), mesh))
                got = bundle.forward(restored["params"], {"tokens": tok}).logits.full_tensor()
        out["logits_err"] = float((got - want).abs().max())
        out["logits_scale"] = float(want.abs().max())
        from repro_torch.data.pipeline import shard_batch
        batch = {"tokens": tokens, "mask": torch.ones(4, 16)}
        out["shard_batch"] = {}
        for seq_axis, table in ((None, filter_rules(DEFAULT_RULES, mesh)),
                                ("act_kv_seq", rules_for(cfg, mesh, "decode"))):
            got = shard_batch(batch, mesh, table, seq_axis=seq_axis)
            out["shard_batch"][str(seq_axis)] = {
                k: [str(tuple(v.placements)), list(v.to_local().shape),
                    bool(torch.equal(v.full_tensor(), batch[k]))] for k, v in got.items()}
    print("RESULT " + json.dumps(out), flush=True)
    dist.destroy_process_group()
''')


def _run_ranks(tmp_path, what, data, world=4, timeout=300):
    """Run WORKER on `world` gloo ranks (a process each, a file store);
    returns rank 0's RESULT."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(world), store, what,
                               str(data)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(world)]
    outs = [p.communicate(timeout=timeout) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e[-4000:]
    line = [x for x in outs[0][0].splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def test_moe_ep_matches_jax_on_four_ranks(tmp_path):
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.nn.moe import init_moe, moe
    from repro.sharding.param import ArrayMaker
    jcfg = JModelConfig(name="t", family="moe", num_layers=1, d_model=32, num_heads=4,
                        num_kv_heads=2, d_ff=64, vocab_size=64, num_experts=8,
                        num_experts_per_tok=2, moe_d_ff=16, n_shared_experts=1,
                        capacity_factor=8.0, tp=4)
    p = init_moe(ArrayMaker(jax.random.PRNGKey(0)), jcfg)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, 32))
    y_ref, _ = moe(jcfg.with_(moe_impl="gather"), p, x)
    data = tmp_path / "moe.npz"
    np.savez(data, x=np.asarray(x), y_ref=np.asarray(y_ref),
             **{f"p.{k}": np.asarray(v) for k, v in p.items()})
    res = _run_ranks(tmp_path, "moe_ep", data)
    assert res["model"]["placement"] == "(Replicate(), Shard(dim=0))"
    assert res["model_data"]["placement"] == "(Shard(dim=0), Shard(dim=0))"
    for name in ("model", "model_data"):
        assert res[name]["y_err"] < 1e-5, res
        assert res[name]["grad_rel_err"] < 1e-5, res


def test_reshard_state_restores_bit_exact_on_four_ranks(tmp_path):
    res = _run_ranks(tmp_path, "reshard", tmp_path / "ckpt")
    assert res["step"] == 5 and res["unequal"] == [], res
    assert res["leaves"] > 0 and res["sharded"] > 0 and res["devices"] == ["cpu"]
    assert res["logits_err"] <= 1e-5 * max(res["logits_scale"], 1.0), res
    # shard_batch: dim 0 over the reference's 'act_batch' spec ('data'), dim 1
    # over `seq_axis`'s ('model' for act_kv_seq at decode), whole on gather
    jmesh = AbstractMesh((2, 2), ("data", "model"))
    jrules_ = jrules.filter_rules(jrules.DEFAULT_RULES, jmesh)
    assert _jspec(jrules.logical_to_spec(["act_batch", None], jrules_)) == ("data",)
    jdecode = jspecs.rules_for(jsmoke_config("qwen3-14b").with_(tp=2), jmesh, "decode")
    assert _jspec(jrules.logical_to_spec(["act_batch", "act_kv_seq"], jdecode)) == \
        ("data", "model")
    for seq_axis, pl, local in (("None", "(Shard(dim=0), Replicate())", [2, 16]),
                                ("act_kv_seq", "(Shard(dim=0), Shard(dim=1))", [2, 8])):
        for name, (got_pl, got_local, whole) in res["shard_batch"][seq_axis].items():
            assert (got_pl, got_local, whole) == (pl, local, True), (seq_axis, name)


# four gloo ranks on a (2, 2) ("data", "model") mesh under the decode rules:
# the reference's decode layout, every k, v, xk and xv sharded on its
# sequence over "model"; (config overrides, greedy steps, max_len)
SEQ_DECODE = {"qwen3-14b": ({"tp": 2}, 6, 32),
              "gemma2-9b": ({}, 8, 48),          # 28 + 8 > the reduced window of 32
              "seamless-m4t-large-v2": ({}, 6, 32)}
SEQ_PROMPT = {"qwen3-14b": 12, "gemma2-9b": 28, "seamless-m4t-large-v2": 12}


def test_seq_sharded_decode_matches_jax_greedy_on_four_ranks(tmp_path):
    """The reference's decode layout on four ranks: ``rules_for(cfg, mesh,
    "decode")`` on a (2, 2) ("data", "model") mesh maps ``act_kv_seq`` to
    "model", so every decode layer attends over its rank's half of the
    cache through K2's plain version with the log-sum-exp, the halves
    combined by all-reduces (``nn.attention._decode_call``). qwen3-14b at
    tp 2, gemma2-9b (global and local layers, softcap, its local rings
    past their wrap) and seamless-m4t-large-v2 (the cross-attention over
    frame-sharded ``xk`` and ``xv``), their params converted from the
    reference: the greedy tokens equal the reference's greedy decoding and
    the port's unsharded path's, and the cache's k, v, xk and xv are
    sharded over "data" on the batch and over "model" on their sequence."""
    base = tmp_path / "seq"
    want = {}
    for arch, (over, steps, max_len) in SEQ_DECODE.items():
        jcfg, cfg = jsmoke_config(arch).with_(**over), smoke_config(arch).with_(**over)
        jbundle = jmake_model(jcfg)
        jparams = jbundle.init(jax.random.PRNGKey(0))
        rng = np.random.default_rng(6)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, SEQ_PROMPT[arch]))}
        if cfg.frontend_tokens:
            batch["frontend"] = rng.standard_normal(
                (4, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
        jbatch = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
                  for k, v in batch.items()}
        want[arch] = np.asarray(jgreedy(jbundle, jparams, jbatch, steps=steps,
                                        max_len=max_len, dtype=jnp.float32)).tolist()
        np.savez(f"{base}.{arch}.npz", **batch,
                 **{f"p.{k}": v.numpy() for k, v in
                    params_from_jax(cfg, jax.tree.map(np.asarray, jparams)).items()})
    (tmp_path / "seq.json").write_text(json.dumps(SEQ_DECODE))
    res = _run_ranks(tmp_path, "seq_decode", base)
    for arch in SEQ_DECODE:
        got = res[arch]
        assert got["act_kv_seq"] == ["model"], got
        assert got["plain"] == want[arch], arch
        assert got["sharded"] == want[arch], arch
        leaves = ("k", "v", "xk", "xv") if arch.startswith("seamless") else ("k", "v")
        assert set(got["cache"]) == set(leaves), got["cache"]
        for name, pls in got["cache"].items():
            assert pls == ["(Shard(dim=0), Shard(dim=1))"], (arch, name, pls)
