"""Collectives over the dims of a ``DeviceMesh``, for ``local_map`` bodies.

Each is a functional collective (``torch.distributed._functional_collectives``)
under an autograd rule of DTensor semantics: a sum all-reduce whose result
is declared replicated passes its gradient through unchanged (every rank
holds the same gradient of a replicated value, used the same way); an
all-gather's gradient is reduce-scattered back (each rank uses the
gathered rows its own way) and a reduce-scatter's all-gathered.
They run on a real process group and on the ``fake`` one, on meta tensors
too, where they move nothing but keep their shapes.
"""

import torch
from torch.distributed import _functional_collectives as funcol


def _wait(t):
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        return _wait(funcol.all_reduce(x, "sum", (mesh, dim)))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.group = (mesh, dim)
        return _wait(funcol.all_gather_tensor(x, 0, (mesh, dim)))

    @staticmethod
    def backward(ctx, g):
        return _wait(funcol.reduce_scatter_tensor(g.contiguous(), "sum", 0, ctx.group)), \
            None, None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.group = (mesh, dim)
        return _wait(funcol.reduce_scatter_tensor(x.contiguous(), "sum", 0, (mesh, dim)))

    @staticmethod
    def backward(ctx, g):
        return _wait(funcol.all_gather_tensor(g.contiguous(), 0, ctx.group)), None, None


def scatter_sum_over(x, mesh, dims):
    """x summed over the ranks of `dims`, each keeping its own chunk of dim
    0 in the mesh's order (the first dim the major one): the inverse of
    ``gather_over``'s layout. Its gradient is all-gathered back."""
    for d in dims:
        x = _ScatterSum.apply(x, mesh, d)
    return x


def sum_over(x, mesh, dims):
    """x summed over the ranks of the mesh dims `dims`, replicated there.
    A dim of one rank leaves x as it is, exactly, with no collective."""
    for d in dims:
        if mesh.size(d) > 1:
            x = _SumReplicated.apply(x, mesh, d)
    return x


def max_over(x, mesh, dims):
    """The elementwise max over the ranks of `dims` (no gradient). A dim of
    one rank leaves x as it is, with no collective."""
    for d in dims:
        if mesh.size(d) > 1:
            x = _wait(funcol.all_reduce(x, "max", (mesh, d)))
    return x


def gather_over(x, mesh, dims):
    """Every rank's x along dim 0, concatenated in the mesh's order over
    `dims` (the first of them the major one)."""
    for d in reversed(list(dims)):
        x = _Gather.apply(x.contiguous(), mesh, d)
    return x


def mesh_index(mesh, dims):
    """This rank's linear index over the mesh dims `dims` (the first the
    major one): the shard it holds of a dim split over them, in DTensor's
    order."""
    coord = mesh.get_coordinate() or [0] * mesh.ndim
    idx = 0
    for d in dims:
        idx = idx * mesh.size(d) + coord[d]
    return idx


def shard_dims(placements, dim):
    """The mesh dims on which `placements` shard tensor dim `dim`."""
    from torch.distributed.tensor import Shard
    return [i for i, pl in enumerate(placements) if isinstance(pl, Shard) and pl.dim == dim]


def grad_placements(placements):
    """The placements of a ``local_map`` input's gradient: a sharded dim
    stays sharded; where the input is replicated each rank computed with
    it on its own shard of the work, so its gradient is partial."""
    from torch.distributed.tensor import Partial, Shard
    return tuple(pl if isinstance(pl, Shard) else Partial() for pl in placements)
