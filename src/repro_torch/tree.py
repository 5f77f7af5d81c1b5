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


# The walks recurse through module-level functions: a recursive closure
# would keep its leaves in a reference cycle (the closure, its own cell)
# until the garbage collector runs, which holds a layer's worth of device
# memory per `tree_map` for as long.

def _walk(node, path: tuple, out: list):
    kids = _children(node)
    if kids is None:
        out.append((path, node))
        return
    for k, v in kids:
        _walk(v, path + (k,), out)


def flatten_with_paths(tree: Tree) -> list[tuple[tuple, Any]]:
    """[(path, leaf)] in the reference's leaf order; a path is the tuple of
    dict keys and sequence indices from the root."""
    out = []
    _walk(tree, (), out)
    return out


def leaves(tree: Tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def _build(node, it):
    if isinstance(node, dict):
        built = {k: _build(node[k], it) for k in sorted(node)}
        return {k: built[k] for k in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_build(v, it) for v in node)
    return next(it)


def unflatten(like: Tree, new_leaves: list) -> Tree:
    """A tree of `like`'s structure holding `new_leaves` in leaf order."""
    return _build(like, iter(new_leaves))


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """`fn` over the leaves of `tree` and the like-structured `rest`."""
    flat = [leaves(t) for t in (tree, *rest)]
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
