"""Parameter makers: one init path gives the parameters and their axes.

The port's counterpart of ``repro.sharding.param``. A module declares every
parameter through a :class:`ParamMaker` as

    mk("wq", (d_model, n_heads, head_dim), ("embed", "heads", "head_dim"), init)

which makes the ``nn.Parameter`` (built by `init` in the maker's dtype on
its device, ``requires_grad=False`` as serving wants) and records its
logical axes on the module. :func:`logical_axes` reads them back by
parameter name, so the parameters and their sharding can never drift
apart. :func:`distribute_module` turns each parameter into a DTensor on a
``DeviceMesh`` with the placements the rules give its axes.
"""

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from repro_torch.sharding.rules import placements, safe_spec


class ParamMaker:
    """Makes `module`'s parameters, recording their logical axes."""

    def __init__(self, module: nn.Module, gen=None, dtype=torch.float32, device="cpu"):
        self.module, self.gen, self.dtype, self.device = module, gen, dtype, device
        if "_param_axes" not in module.__dict__:
            module._param_axes = {}

    def __call__(self, name: str, shape: Tuple[int, ...], axes: Tuple[Optional[str], ...],
                 init: Callable, dtype=None) -> nn.Parameter:
        if len(shape) != len(axes):
            raise ValueError(f"{name}: shape {shape} vs axes {axes}")
        self.module._param_axes[name] = tuple(axes)
        return nn.Parameter(init(self.gen, tuple(shape), dtype or self.dtype, self.device),
                            requires_grad=False)


def logical_axes(module: nn.Module) -> dict:
    """{parameter name: logical axes} of every parameter of `module`, in
    ``named_parameters`` order."""
    axes = {}
    for prefix, mod in module.named_modules():
        for name, ax in mod.__dict__.get("_param_axes", {}).items():
            if getattr(mod, name, None) is not None:
                axes[f"{prefix}.{name}" if prefix else name] = ax
    missing = [n for n, _ in module.named_parameters() if n not in axes]
    if missing:
        raise ValueError(f"parameters made without logical axes: {missing}")
    return {n: axes[n] for n, _ in module.named_parameters()}


def shard_tensor(t: torch.Tensor, mesh, placements_):
    """`t` (the global tensor, on every rank) as a DTensor with
    `placements_`, each rank keeping its own chunks, with no collective. A
    meta tensor gives a DTensor of meta shards."""
    from torch.distributed.tensor import DTensor, Shard

    local = t
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements_):
        if isinstance(pl, Shard):
            n = mesh.size(i)
            if local.shape[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(t.shape)} does not split {n} ways")
            step = local.shape[pl.dim] // n
            local = local.narrow(pl.dim, (coord[i] if coord else 0) * step, step)
    return DTensor.from_local(local.contiguous(), mesh, placements_, run_check=False,
                              shape=t.shape, stride=t.contiguous().stride()
                              if t.device.type != "meta" else _stride(t.shape))


def empty_like_on(t, device):
    """A DTensor with `t`'s global shape, dtype, mesh and placements whose
    shards are zeros on `device` (a plain tensor: zeros of its shape)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return torch.zeros(t.shape, dtype=t.dtype, device=device)
    local = torch.zeros(t.to_local().shape, dtype=t.dtype, device=device)
    return DTensor.from_local(local, t.device_mesh, t.placements, run_check=False,
                              shape=t.shape, stride=_stride(t.shape))


def materialize(module: nn.Module, device) -> nn.Module:
    """Every (meta) parameter of `module` replaced by zeros on `device`
    with the same placements (in place; returns the module)."""
    for name, p in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        setattr(mod, leaf, nn.Parameter(empty_like_on(p.detach(), device),
                                        requires_grad=p.requires_grad))
    return module


def _stride(shape):
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def distribute_module(module: nn.Module, mesh, rules) -> nn.Module:
    """Replace every parameter of `module` by a DTensor on `mesh` with the
    rules' placements, each dim's sharding dropped where the mesh does not
    divide it (``safe_spec``); in place, returns the module. The plan is
    made before any parameter changes."""
    shapes = {n: p.shape for n, p in module.named_parameters()}
    plan = {n: placements(safe_spec(shapes[n], ax, rules, mesh), mesh)
            for n, ax in logical_axes(module).items()}
    for name, pls in plan.items():
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        p = getattr(mod, leaf)
        setattr(mod, leaf, nn.Parameter(shard_tensor(p.detach(), mesh, pls),
                                        requires_grad=p.requires_grad))
    return module
