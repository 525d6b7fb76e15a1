"""Sharded stand-ins for every step's inputs, with no allocation.

The port's counterpart of ``repro.launch.specs``: the train state (params
and ZeRO-1 sharded optimizer moments), trajectory and prefill batches and
decode caches of any (arch x input shape x mesh) cell, as DTensors of meta
shards with the rules' placements (the reference's sharded
``ShapeDtypeStruct``s). ``rules_for`` and ``opt_rules_for`` are copies;
the cache's path rules (the reference's ``_cache_leaf_axes``) are
``sharding.rules.cache_leaf_axes``, which the models read too.
"""

import torch

from repro_torch.configs.shapes import InputShape
from repro_torch.sharding.param import distribute_module, logical_axes, shard_tensor
from repro_torch.sharding.rules import (DEFAULT_RULES, FSDP_POD_RULES, FSDP_RULES,
                                        cache_leaf_axes, filter_rules, placements, safe_spec,
                                        tree_map_with_keys)


def rules_for(cfg, mesh, kind="train"):
    """Parameter rules per the config's FSDP setting, filtered to the mesh,
    with the sequence-parallel and KV-seq-shard activation rules of the
    config's flags. pure_dp applies to training only: serving batches
    cannot fill every rank with batch parallelism, so serving keeps TP."""
    base = dict({"none": DEFAULT_RULES, "data": FSDP_RULES,
                 "pod_data": FSDP_POD_RULES}[cfg.fsdp])
    if cfg.pure_dp and kind == "train":
        # replicate all weight axes; fold 'model' into the batch axes
        for k in ("vocab", "heads", "mlp", "experts", "act_heads", "act_mlp",
                  "act_experts", "act_vocab"):
            base[k] = ()
        base["act_batch"] = ("pod", "data", "model")
        base["act_kv_seq"] = ()
    if cfg.seq_parallel:
        base["act_res_seq"] = ("model",)
    if cfg.kv_seq_shard and not (cfg.pure_dp and kind == "train"):
        base["act_kv_seq"] = ("model",)
    return filter_rules(base, mesh)


def opt_rules_for(cfg, mesh):
    """Optimizer-state rules: ZeRO-1, the moments FSDP-sharded over 'data'
    (and 'pod' for pod_data) even where the params are not."""
    base = FSDP_POD_RULES if cfg.fsdp == "pod_data" else FSDP_RULES
    return filter_rules(base, mesh)


def params_specs(bundle, mesh, rules, dtype=None):
    """The params as DTensors of meta shards with the rules' placements."""
    return distribute_module(bundle.init(0, device="meta", dtype=dtype), mesh, rules)


def state_specs(bundle, optimizer, mesh, cfg, dtype=None):
    """The train state: params (the param rules, trainable) and the
    optimizer's moments (the ZeRO-1 rules), each a DTensor of meta shards;
    step 0."""
    params = params_specs(bundle, mesh, rules_for(cfg, mesh), dtype)
    params.requires_grad_(True)
    o_rules = opt_rules_for(cfg, mesh)
    axes = logical_axes(params)
    named = dict(params.named_parameters())
    opt = optimizer.init({n: torch.empty(p.shape, dtype=p.dtype, device="meta")
                          for n, p in named.items()})
    opt_state = {
        k: {n: shard_tensor(m, mesh, placements(safe_spec(m.shape, axes[n], o_rules, mesh),
                                                mesh))
            for n, m in v.items()} if isinstance(v, dict) else v
        for k, v in opt.items()}
    return {"params": params, "opt_state": opt_state, "step": 0}


def batch_specs(cfg, shape: InputShape, mesh, rules, with_rl_fields=True):
    """A trajectory (or prefill) batch of meta DTensors, dim 0 over
    'act_batch'; the text is shortened by the frontend's positions."""
    b, s = shape.global_batch, shape.seq_len
    f = cfg.frontend_tokens
    s_text = s - f if (f and cfg.family != "encdec") else s

    def leaf(shape_, dtype):
        axes = ("act_batch",) + (None,) * (len(shape_) - 1)
        return shard_tensor(torch.empty(shape_, dtype=dtype, device="meta"), mesh,
                            placements(safe_spec(shape_, axes, rules, mesh), mesh))
    out = {"tokens": leaf((b, s_text), torch.int32)}
    if with_rl_fields:
        for k in ("rewards", "discounts", "behavior_logprobs", "mask"):
            out[k] = leaf((b, s_text), torch.float32)
    if f:
        out["frontend"] = leaf((b, f, cfg.frontend_dim), torch.bfloat16)
    return out


def cache_axes(bundle, shape: InputShape, dtype=torch.bfloat16):
    """(keystr, shape, logical axes) of every leaf of the decode cache."""
    cache = bundle.init_cache(shape.global_batch, shape.seq_len, dtype, device="meta")
    out = []

    def leaf(ks, x):
        if isinstance(x, torch.Tensor):
            is_int = not x.is_floating_point()
            out.append((ks, tuple(x.shape), cache_leaf_axes(ks, x.shape, is_int)))
        return x
    tree_map_with_keys(leaf, cache)
    return out


def cache_specs(bundle, shape: InputShape, mesh, rules, dtype=torch.bfloat16):
    """The decode cache as DTensors of meta shards ('index' stays a plain
    0-d tensor)."""
    from repro_torch.sharding.ctx import distribute_cache, sharding_ctx
    with sharding_ctx(mesh, rules):
        return distribute_cache(bundle.init_cache(shape.global_batch, shape.seq_len,
                                                  dtype, device="meta"))


