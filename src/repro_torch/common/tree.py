"""Leaf-wise maps over nested dicts, lists and tuples of tensors (the
subset of the JAX package's pytree helpers that serving and training
need)."""
from __future__ import annotations

from typing import Any, Callable

import torch

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree, is_leaf=None) -> Tree:
    """Apply ``fn`` leaf-wise over trees of the same structure.  Containers
    are dicts, lists and tuples; anything else (or what ``is_leaf`` accepts)
    is a leaf."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf)
                for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
               for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree: Tree, is_leaf=None) -> list:
    out = []
    tree_map(out.append, tree, is_leaf=is_leaf)
    return out


def tree_paths(tree: Tree, prefix: str = "") -> dict:
    """``{path: leaf}``, the path of a leaf its dict keys and list indices
    joined by '/' (``params/bb/blocks/0/w``), as the checkpoints key it."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(tree_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def tree_rebuild(template: Tree, leaves) -> Tree:
    """``template``'s structure with its leaves replaced, in
    :func:`tree_leaves` order, by ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def tree_cast(tree: Tree, dtype: torch.dtype) -> Tree:
    """Cast all floating tensor leaves to ``dtype``; leave the rest alone."""
    def _cast(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x
    return tree_map(_cast, tree)


def tree_to(tree: Tree, device) -> Tree:
    """Move every tensor leaf to ``device``."""
    return tree_map(lambda x: x.to(device) if isinstance(x, torch.Tensor) else x,
                    tree)


def tree_detach(tree: Tree) -> Tree:
    """Every tensor leaf detached from the autograd graph (the JAX
    package's ``tree_stop_gradient``)."""
    return tree_map(lambda x: x.detach() if isinstance(x, torch.Tensor) else x, tree)


def global_norm(tree: Tree) -> torch.Tensor:
    """L2 norm over the concatenation of all leaves, in fp32."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))
