"""Logical-axis sharding rules (MaxText-style), as plain Python.

A copy of ``repro.sharding.rules``: every parameter and activation
dimension carries a *logical* axis name ('embed', 'heads', 'mlp',
'experts', 'vocab', ...), and a rule table maps each logical name to zero
or more *mesh* axes. A spec is a tuple with one entry a dimension: None
(replicated), a mesh axis name, or a tuple of names (the dimension split
over several mesh axes, the first the major one), trailing Nones dropped,
as a ``jax.sharding.PartitionSpec`` holds them.

``placements`` turns a spec into DTensor placements on a ``DeviceMesh``:
``Shard(d)`` on every mesh dimension named on tensor dimension d,
``Replicate()`` on the others. A dimension over two mesh axes becomes
``Shard(d)`` on both, split in the mesh's order (the major axis first).

Divisibility is the caller's contract: configs pad head counts and vocab
to multiples of the TP degree (``configs.base.pad_to``); ``safe_spec``
drops the mesh axes a dimension does not divide.
"""

from typing import Mapping, Sequence, Tuple

AxisRules = Mapping[str, Tuple[str, ...]]

# Baseline rules: tensor-parallel over 'model', batch over pod x data.
DEFAULT_RULES: AxisRules = {
    # parameter axes
    "vocab": ("model",),
    "embed": (),              # d_model: replicated (non-FSDP)
    "heads": ("model",),
    "kv_heads": (),           # kv heads are replicated when < tp degree
    "head_dim": (),
    "qk_rank": (),            # MLA latent ranks: small, replicated
    "mlp": ("model",),
    "experts": ("model",),    # expert parallelism
    "expert_mlp": (),         # per-expert ffn dim (EP already on 'model')
    "layers": (),             # the reference's stacked-layer axis
    "conv": (),
    "state": (),              # SSM state dim
    # activation axes
    "act_batch": ("pod", "data"),
    "act_seq": (),
    "act_res_seq": (),        # Megatron-SP residual stream (rules_for)
    "act_kv_seq": (),         # decode caches' sequence (rules_for)
    "act_heads": ("model",),
    "act_mlp": ("model",),
    "act_embed": (),
    "act_experts": ("model",),
    "act_vocab": ("model",),
}

# FSDP: additionally shard the d_model dim of every weight over 'data'.
FSDP_RULES: AxisRules = dict(DEFAULT_RULES, embed=("data",))

# FSDP over pod x data (the 671B config).
FSDP_POD_RULES: AxisRules = dict(DEFAULT_RULES, embed=("pod", "data"))

# Single-device rules: everything replicated.
REPLICATED_RULES: AxisRules = dict({k: () for k in DEFAULT_RULES}, act_batch=())


class AbstractMesh:
    """A mesh's axis names and sizes, with no devices and no process group:
    what the rules need (``jax.sharding.AbstractMesh``'s counterpart)."""

    def __init__(self, shape, axis_names):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} vs axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))


def mesh_axes(mesh) -> Tuple[str, ...]:
    """The mesh's axis names: a ``DeviceMesh``'s dim names or an
    ``AbstractMesh``'s axis names."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or an ``AbstractMesh``."""
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.shape)
    return dict(zip(mesh_axes(mesh), tuple(mesh.shape)))


def _entry(kept):
    if not kept:
        return None
    return kept[0] if len(kept) == 1 else tuple(kept)


def _trim(spec):
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def logical_to_spec(axes: Sequence[str], rules: AxisRules) -> tuple:
    """Map a tuple of logical axis names to a spec. A mesh axis is used at
    most once: a later dimension naming it again is left replicated."""
    spec, used = [], set()
    for name in axes:
        if name is None:
            spec.append(None)
            continue
        mesh_axes_ = tuple(a for a in rules.get(name, ()) if a not in used)
        used |= set(mesh_axes_)
        spec.append(_entry(mesh_axes_))
    return _trim(spec)


def filter_rules(rules: AxisRules, mesh) -> AxisRules:
    """Drop mesh axes that don't exist in `mesh` (e.g. 'pod' on one pod)."""
    names = set(mesh_axes(mesh))
    return {k: tuple(a for a in v if a in names) for k, v in rules.items()}


def safe_spec(shape, axes, rules: AxisRules, mesh) -> tuple:
    """logical_to_spec, but drops sharding on dims the mesh doesn't divide
    (e.g. batch=1 long-context decode can't shard its batch axis)."""
    sizes = mesh_sizes(mesh)
    spec, used = [], set()
    for dim, name in zip(shape, axes):
        if name is None:
            spec.append(None)
            continue
        mesh_axes_ = tuple(a for a in rules.get(name, ())
                           if a in sizes and a not in used)
        total, kept = 1, []
        for a in mesh_axes_:
            if dim % (total * sizes[a]) == 0:
                kept.append(a)
                total *= sizes[a]
        used |= set(kept)
        spec.append(_entry(kept))
    return _trim(spec)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of one rank's shard of a tensor of `shape` under `spec`."""
    sizes = mesh_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in spec_axes(entry):
            out[d] //= sizes[a]
    return tuple(out)


def placements(spec, mesh) -> tuple:
    """DTensor placements of `spec` on `mesh`, one a mesh dimension."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axes(mesh)
    dim_of = {}
    for d, entry in enumerate(spec):
        for a in spec_axes(entry):
            if a not in names:
                raise ValueError(f"spec {spec} names {a!r}, not an axis of the mesh {names}")
            dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate() for a in names)


def cache_leaf_axes(keystr: str, shape, is_int: bool) -> tuple:
    """Logical axes of a decode-cache leaf from its path, rank and dtype:
    ``repro.launch.specs._cache_leaf_axes``'s rules for an unstacked leaf
    (the port keeps one cache entry a layer, so no leaf has the reference's
    leading layer axis). `keystr` names the path as JAX's ``keystr`` does,
    e.g. ``['layers'][3]['k']``."""
    nd = len(shape)
    if "'pos'" in keystr or is_int:
        return (None,) * nd
    for nm in ("'k'", "'v'", "'xk'", "'xv'", "c_kv", "k_rope"):
        if nm in keystr:
            axes = [None] * nd
            axes[0] = "act_batch"
            if nd > 2:               # (B, S, ...): shard the cache's sequence too
                axes[1] = "act_kv_seq"
            return tuple(axes)
    if nd >= 2:                      # recurrent states
        axes = [None] * nd
        axes[0] = "act_batch"
        if nd == 4:                  # mamba's ssm state (B, H, P, N)
            axes[1] = "act_heads"
        else:                        # rglru h / conv state: last dim wide
            axes[-1] = "act_mlp"
        return tuple(axes)
    return (None,) * nd


def tree_leaves_with_keys(tree, prefix=""):
    """(keystr, leaf) of a tree of dicts, lists and tuples, depth first."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves_with_keys(v, f"{prefix}['{k}']")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_keys(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def tree_map_with_keys(fn, tree, prefix=""):
    """`tree` with every leaf replaced by fn(keystr, leaf); lists stay
    lists and tuples tuples."""
    if isinstance(tree, dict):
        return {k: tree_map_with_keys(fn, v, f"{prefix}['{k}']") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map_with_keys(fn, v, f"{prefix}[{i}]") for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(prefix, tree)
