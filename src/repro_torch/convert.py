"""Parameter conversion from the JAX package's param tree to the port's.

The JAX models stack each block parameter along a leading layer axis, under
``blocks.*`` in Mamba; the port keeps one module per layer under
``blocks.{i}.*``. The LM and RecurrentGemma scan periods of P layers
(P = len(attn_pattern), 2 for gemma2's local/global, 1 for the others; P =
len(block_pattern) for RecurrentGemma): leaf ``[j]`` of ``main.p{k}.*`` is
layer P*j + k, after the LM's first dense layers (``pre.p0``, DeepSeek),
which come first (``models.lm.layer_plan``), and RecurrentGemma's unscanned
``rest{j}.*`` that follow the n_scan periods are layers n_scan*P + j. The
encoder-decoder stacks its encoder layers under ``enc.*`` and its decoder
layers under ``dec.*``: leaf ``[i]`` is the port's ``enc.{i}.*`` or
``dec.{i}.*``.
Every tensor keeps the JAX layout (wq (d,H,hd), wo (H,hd,d), wi (d,ff),
an MoE's wi (E,d,f), MLA's wuq (qr,H,dn+dr), unembed (d,V), in_proj
(d, ...), conv.w (W,C)), so only the layer axis moves. The R2D2 agent
(``atari``) stacks nothing, so its names and layouts pass through, as
do the on-policy MLP's (`mlp_params_from_jax`).
"""

import numpy as np
import torch


def _flatten(tree, prefix=""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, f"{name}.")
        else:
            yield name, val


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))   # writable, contiguous


def params_from_jax(cfg, params_np) -> dict:
    """JAX params (a nested dict of numpy arrays) -> the state dict of the
    port's model for `cfg.family` (``models.lm.LM`` for dense and moe,
    ``models.mamba.Mamba`` for ssm, ``models.recurrentgemma.RecurrentGemma``
    for hybrid, ``models.encdec.EncDec`` for encdec, ``models.atari.Atari``
    for atari): CPU tensors, the arrays' dtypes."""
    if cfg.family == "atari":
        return {name: _tensor(arr) for name, arr in _flatten(params_np)}
    if cfg.family == "encdec":
        return _encdec_from_jax(cfg, params_np)
    if cfg.family == "hybrid":
        return _periods_from_jax(params_np, len(cfg.block_pattern),
                                 cfg.num_layers // len(cfg.block_pattern))
    if cfg.family != "ssm":
        return _lm_from_jax(cfg, params_np)
    out = {}
    for name, arr in _flatten(params_np):
        if name.startswith("blocks."):
            rest = name[len("blocks."):]
            if arr.shape[0] != cfg.num_layers:
                raise ValueError(f"{name}: leading axis {arr.shape[0]} != "
                                 f"num_layers {cfg.num_layers}")
            for i in range(cfg.num_layers):
                out[f"blocks.{i}.{rest}"] = _tensor(arr[i])
        else:
            out[name] = _tensor(arr)
    return out


def _lm_from_jax(cfg, params_np) -> dict:
    """The LM (dense and moe): layer i of the port is leaf ``spec.leaf`` of
    the stack ``spec.stack`` ("pre.p0" for DeepSeek's first dense layers,
    then "main.p{k}"), ``spec = models.lm.layer_plan(cfg)[i]``. Everything
    else (embed, the heads, final_norm, the MTP head ``mtp.*``, which
    stacks nothing) keeps its name. An MoE's router stays fp32, as the
    arrays come."""
    from repro_torch.models.lm import layer_plan

    plan = layer_plan(cfg)
    period = len(cfg.attn_pattern)
    if set(params_np.get("main", {})) != {f"p{k}" for k in range(period)}:
        raise ValueError(f"main stacks {sorted(params_np.get('main', {}))} do not "
                         f"match the pattern {cfg.attn_pattern}")
    if ("pre" in params_np) != bool(cfg.first_dense_layers):
        raise ValueError(f"stack 'pre' {'present' if 'pre' in params_np else 'absent'}, "
                         f"first_dense_layers {cfg.first_dense_layers}")
    layers = {}
    for i, spec in enumerate(plan):
        layers.setdefault(spec.stack, []).append((i, spec.leaf))
    out = {}
    for name, arr in _flatten(params_np):
        head, _, rest = name.partition(".")
        if head not in ("pre", "main"):
            out[name] = _tensor(arr)
            continue
        part, _, rest = rest.partition(".")
        stack = layers[f"{head}.{part}"]
        if arr.shape[0] != len(stack):
            raise ValueError(f"{name}: leading axis {arr.shape[0]} != {len(stack)} layers")
        for i, leaf in stack:
            out[f"blocks.{i}.{rest}"] = _tensor(arr[leaf])
    return out


def _encdec_from_jax(cfg, params_np) -> dict:
    """The encoder-decoder: leaf [i] of a stacked ``enc.*`` or ``dec.*``
    array is layer i of the port's ``enc`` or ``dec`` list; everything else
    (embed, frontend, the norms, the value head) keeps its name."""
    n_layers = {"enc": cfg.enc_layers, "dec": cfg.dec_layers}
    out = {}
    for name, arr in _flatten(params_np):
        head, _, rest = name.partition(".")
        if head not in n_layers:
            out[name] = _tensor(arr)
            continue
        if arr.shape[0] != n_layers[head]:
            raise ValueError(f"{name}: leading axis {arr.shape[0]} != {n_layers[head]} layers")
        for i in range(n_layers[head]):
            out[f"{head}.{i}.{rest}"] = _tensor(arr[i])
    return out


def _periods_from_jax(params_np, period, n_scan) -> dict:
    out = {}
    for name, arr in _flatten(params_np):
        head, _, rest = name.partition(".")
        if head == "main":
            part, _, rest = rest.partition(".")
            k = int(part[1:])                       # "p{k}"
            if arr.shape[0] != n_scan:
                raise ValueError(f"{name}: leading axis {arr.shape[0]} != {n_scan} periods")
            for j in range(n_scan):
                out[f"blocks.{period * j + k}.{rest}"] = _tensor(arr[j])
        elif head.startswith("rest"):
            out[f"blocks.{n_scan * period + int(head[4:])}.{rest}"] = _tensor(arr)
        else:
            out[name] = _tensor(arr)
    return out


def mlp_params_from_jax(params_np) -> dict:
    """``repro.onpolicy.mlp_actor_critic`` params (a flat dict of numpy
    arrays: w1 b1 wp bp wv bv) -> the port's ``repro_torch.onpolicy``
    params: CPU tensors under the same names and layouts."""
    return {name: _tensor(arr) for name, arr in _flatten(params_np)}
