"""Sharding context: lets model code state *logical* activation shardings.

The port's counterpart of ``repro.sharding.ctx``. ``with sharding_ctx(mesh,
rules): ...`` makes :func:`constrain` redistribute a DTensor activation to
the placements the rules give its logical axes (``safe_spec``, so axes the
mesh does not divide are dropped); outside a context, or on a plain
tensor, it is the identity. This is how one model definition runs
unmodified on one card, on a one-rank ``DeviceMesh`` and on a fake mesh of
256 ranks. Inside a context plain tensors meeting DTensors count as
replicated (``implicit_replication``), as a constant does under GSPMD.
"""

import contextlib
import threading

import torch

from repro_torch.sharding.rules import placements, safe_spec

_state = threading.local()


def current():
    """(mesh, rules) of the innermost context, or None."""
    return getattr(_state, "ctx", None)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


@contextlib.contextmanager
def sharding_ctx(mesh, rules):
    from torch.distributed.tensor.experimental import implicit_replication

    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, rules)
    try:
        # implicit_replication turns the flag off on exit: only the
        # outermost context enters it
        with implicit_replication() if prev is None else contextlib.nullcontext():
            yield
    finally:
        _state.ctx = prev


def spec_placements(shape, axes):
    """The current context's placements for a tensor of `shape` with
    logical `axes`."""
    mesh, rules = current()
    return placements(safe_spec(shape, axes, rules, mesh), mesh)


def constrain(x, *logical_axes):
    """Redistribute the DTensor `x` to the logical axes (one name, or None,
    a dim); a plain tensor, or any tensor outside a context, passes."""
    if current() is None or not is_dtensor(x):
        return x
    want = spec_placements(x.shape, logical_axes)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def distribute(x, *logical_axes):
    """`x`, a plain tensor holding the global value on every rank, as a
    DTensor with the logical axes' placements in a context (no collective:
    each rank keeps its chunks); outside a context, `x` itself."""
    if current() is None or is_dtensor(x) or not isinstance(x, torch.Tensor):
        return x
    from repro_torch.sharding.param import shard_tensor
    mesh, _ = current()
    return shard_tensor(x, mesh, spec_placements(x.shape, logical_axes))


def gather_dim(w, dim):
    """`w` whole along `dim`: a DTensor sharded there (FSDP's d_model over
    'data') is all-gathered over those mesh dims before use, as ZeRO-3
    gathers a weight; anything else as it is."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate, Shard
    want = tuple(Replicate() if isinstance(pl, Shard) and pl.dim == dim else pl
                 for pl in w.placements)
    return w if want == tuple(w.placements) else w.redistribute(w.device_mesh, want)


def to_plain(x):
    """The full value of a DTensor as a plain tensor (gathered where it is
    sharded); anything else as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def distribute_cache(cache):
    """A decode cache with every tensor leaf but 'index' distributed by its
    path's logical axes (``rules.cache_leaf_axes``) in a context, a leaf
    that is a DTensor already (the encoder-decoder's cross K/V, computed
    under the mesh) redistributed to them, as the reference's prefill lays
    its cache out; the cache itself outside one."""
    if current() is None:
        return cache
    from repro_torch.sharding.rules import cache_leaf_axes, tree_map_with_keys

    def leaf(ks, x):
        if not isinstance(x, torch.Tensor) or ks == "['index']":
            return x
        is_int = not (x.is_floating_point() or x.is_complex())
        axes = cache_leaf_axes(ks, x.shape, is_int)
        return constrain(x, *axes) if is_dtensor(x) else distribute(x, *axes)
    return tree_map_with_keys(leaf, cache)
