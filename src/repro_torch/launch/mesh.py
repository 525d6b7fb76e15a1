"""Device meshes: the production meshes, small ones and a one-rank mesh.

The port's counterpart of ``repro.launch.mesh``. Meshes are built by
functions, never at import, as the reference's: a ``DeviceMesh`` needs a
default process group, and a process holds one.

- ``make_production_mesh`` and ``make_mesh`` build a ``DeviceMesh`` over the
  default group's ranks; the dry run makes that group with
  ``init_fake_group`` (the ``fake`` backend: 256 or 512 ranks in one
  process, collectives that move nothing, meta tensors on every rank).
- ``single_device_mesh`` is a one-rank mesh ``("data",)`` on one device,
  over a one-rank group with an explicit in-process store, so no
  environment variable is read.
- ``use_mesh`` is the reference's mesh context; DTensors carry their mesh,
  so it only hands the mesh back.
"""

import contextlib

import numpy as np
import torch
import torch.distributed as dist


def init_fake_group(world_size: int):
    """Make the default process group the ``fake`` backend's, `world_size`
    ranks seen from rank 0 (the dry run's); an existing fake group of that
    size is kept."""
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != world_size:
            raise RuntimeError(f"a {dist.get_backend()} group of {dist.get_world_size()} "
                               f"ranks exists; the dry run needs a fake group of {world_size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def make_mesh(shape, axes, device_type="cpu"):
    """A DeviceMesh of `shape` named `axes` over ranks 0 .. prod(shape) - 1
    of the default group, in row-major order."""
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(int(np.prod(shape))).reshape(tuple(shape))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type="cpu"):
    """16 x 16 = 256 ranks ("data", "model"); 2 x 16 x 16 = 512 across two
    pods ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def single_device_mesh(device="cuda"):
    """A one-rank DeviceMesh ("data",) on `device`'s type, over a one-rank
    gloo group with an in-process store (made here unless a one-rank group
    exists)."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    elif dist.get_world_size() != 1:
        raise RuntimeError(f"the default group has {dist.get_world_size()} ranks, not 1")
    return DeviceMesh(torch.device(device).type, [0], mesh_dim_names=("data",))


@contextlib.contextmanager
def use_mesh(mesh):
    """The reference's mesh context. DTensors carry their mesh, so it holds
    nothing and yields `mesh`."""
    yield mesh
