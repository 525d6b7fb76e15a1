"""Small tree utilities over dicts, lists and tuples of tensors.

Mirrors ``repro.utils.tree``. A tree here is a tensor, or a dict, list or
tuple of trees; an ``nn.Module`` stands for its ``named_parameters()``.
"""

import torch
from torch import nn


def leaves(tree) -> list:
    """The tensors of `tree`, dicts in key order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, nn.Module):
        return [p for _, p in tree.named_parameters()]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def tree_size(tree) -> int:
    """Total number of elements across all leaves."""
    return sum(x.numel() for x in leaves(tree))


def tree_bytes(tree) -> int:
    """Total bytes across all leaves (uses each leaf's dtype)."""
    return sum(x.numel() * x.element_size() for x in leaves(tree))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, accumulated in fp32: a 0-d
    tensor on the leaves' device (no host sync)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves(tree)))
