"""Nested-dict trees of tensors (parameters, optimizer state, checkpoints).

Leaves are visited in the JAX package's order (`jax.tree.leaves`: dict keys
sorted, list and tuple items in order), so sums over leaves add in the
reference's order and checkpoint keys are the reference's paths.
"""
from __future__ import annotations

from typing import Any, Callable

Tree = Any


def _children(node):
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def flatten_with_paths(tree: Tree) -> list[tuple[tuple, Any]]:
    """[(path, leaf)] in the reference's leaf order; a path is the tuple of
    dict keys and sequence indices from the root."""
    out = []

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            out.append((path, node))
            return
        for k, v in kids:
            walk(v, path + (k,))

    walk(tree, ())
    return out


def leaves(tree: Tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(like: Tree, new_leaves: list) -> Tree:
    """A tree of `like`'s structure holding `new_leaves` in leaf order."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """`fn` over the leaves of `tree` and the like-structured `rest`."""
    flat = [leaves(t) for t in (tree, *rest)]
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
