"""Parameter conversion from the JAX package's param tree to the port's.

The JAX LM stacks each block parameter along a leading layer axis under
``main.p0.*`` (one pattern period, scanned); the port keeps one module per
layer under ``blocks.{i}.*``. Every tensor keeps the JAX layout (wq (d,H,hd),
wo (H,hd,d), wi (d,ff), unembed (d,V)), so only the layer axis moves.
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
    """JAX dense-LM params (a nested dict of numpy arrays) -> the state dict
    of ``repro_torch.models.lm.LM`` (CPU tensors, the arrays' dtypes)."""
    if "pre" in params_np or set(params_np.get("main", {})) != {"p0"}:
        raise NotImplementedError("only single-period stacks without dense "
                                  "pre-layers are ported (dense global LM)")
    out = {}
    for name, arr in _flatten(params_np):
        if name.startswith("main.p0."):
            rest = name[len("main.p0."):]
            if arr.shape[0] != cfg.num_layers:
                raise ValueError(f"{name}: leading axis {arr.shape[0]} != "
                                 f"num_layers {cfg.num_layers}")
            for i in range(cfg.num_layers):
                out[f"blocks.{i}.{rest}"] = _tensor(arr[i])
        else:
            out[name] = _tensor(arr)
    return out
