"""Nested-dict trees of tensors: the port's stand-in for JAX pytrees.

Leaves are visited in sorted-key order, the order in which ``jax.tree``
flattens a dict, so a leaf list here lines up with the JAX package's leaf
list of the same tree.
"""
from __future__ import annotations

from typing import Any, Callable


def flatten_with_paths(tree, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """``[(path, leaf), ...]``; a path is the tuple of dict keys."""
    if not isinstance(tree, dict):
        return [(path, tree)]
    out = []
    for k in sorted(tree):
        out.extend(flatten_with_paths(tree[k], path + (k,)))
    return out


def leaves(tree) -> list:
    return [leaf for _p, leaf in flatten_with_paths(tree)]


def unflatten(like, new_leaves) -> Any:
    """A tree shaped like ``like`` holding ``new_leaves`` in leaf order."""
    it = iter(new_leaves)

    def build(t):
        if not isinstance(t, dict):
            return next(it)
        return {k: build(t[k]) for k in sorted(t)}

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def map_tree(fn: Callable, tree, *rest) -> Any:
    """``fn`` over corresponding leaves of trees of one structure."""
    others = [leaves(t) for t in rest]
    return unflatten(tree, [fn(leaf, *(o[i] for o in others))
                            for i, leaf in enumerate(leaves(tree))])
