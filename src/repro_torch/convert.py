"""Parameter conversion from the JAX package's param tree to the port's.

The JAX models stack each block parameter along a leading layer axis, under
``main.p0.*`` in the dense LM (one pattern period, scanned) and under
``blocks.*`` in Mamba; the port keeps one module per layer under
``blocks.{i}.*``. Every tensor keeps the JAX layout (wq (d,H,hd), wo
(H,hd,d), wi (d,ff), unembed (d,V), in_proj (d, ...), conv.w (W,C)), so
only the layer axis moves.
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
    port's model for `cfg.family` (``models.lm.LM`` for dense,
    ``models.mamba.Mamba`` for ssm): CPU tensors, the arrays' dtypes."""
    if cfg.family == "ssm":
        stacked = "blocks."
    elif "pre" in params_np or set(params_np.get("main", {})) != {"p0"}:
        raise NotImplementedError("only single-period stacks without dense "
                                  "pre-layers are ported (dense global LM)")
    else:
        stacked = "main.p0."
    out = {}
    for name, arr in _flatten(params_np):
        if name.startswith(stacked):
            rest = name[len(stacked):]
            if arr.shape[0] != cfg.num_layers:
                raise ValueError(f"{name}: leading axis {arr.shape[0]} != "
                                 f"num_layers {cfg.num_layers}")
            for i in range(cfg.num_layers):
                out[f"blocks.{i}.{rest}"] = _tensor(arr[i])
        else:
            out[name] = _tensor(arr)
    return out
