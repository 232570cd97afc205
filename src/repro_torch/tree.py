"""Maps over the port's parameter and cache trees: nested dicts and lists
(or tuples) with tensors at the leaves, the shape the reference keeps
its pytrees in.

:func:`tree_flatten` lists the leaves in JAX's order (dict keys sorted),
which the tracer numbers its input nodes by, so that leaf ``i`` is the
same tensor in both packages' graphs; :func:`tree_map` keeps a dict's
own order.

The path handed to :func:`tree_map_with_path` is the tuple of dict keys
and list indices from the root to the leaf; the paged KV cache reads it
to find a leaf's block axis (leaves under ``"periods"`` carry a leading
``num_periods`` axis).
"""
from __future__ import annotations

from typing import Any, Callable


def tree_map_with_path(fn: Callable[..., Any], tree, *rest,
                       path: tuple = ()):
    """``fn(path, leaf, *other_leaves)`` over the leaves of ``tree``;
    ``rest`` are trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map_with_path(fn, v, *(r[i] for r in rest),
                               path=path + (i,))
            for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def tree_map(fn: Callable[..., Any], tree, *rest):
    """``fn(leaf, *other_leaves)`` over the leaves of ``tree``."""
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


class _Leaf:
    """Marks a leaf's place in a tree structure."""

    def __repr__(self) -> str:
        return "*"


LEAF = _Leaf()


def tree_flatten(tree) -> tuple[list, Any]:
    """Leaves of ``tree`` in JAX's order — dict keys sorted, lists and
    tuples in order, ``None`` holds no leaf — and the structure that
    :func:`tree_unflatten` rebuilds the tree from."""
    leaves: list = []

    def go(t):
        if isinstance(t, dict):
            return {k: go(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(go(v) for v in t)
        if t is None:
            return None
        leaves.append(t)
        return LEAF
    return leaves, go(tree)


def tree_unflatten(structure, leaves):
    """Inverse of :func:`tree_flatten` (dicts come back with sorted
    keys)."""
    it = iter(leaves)

    def go(s):
        if isinstance(s, dict):
            return {k: go(v) for k, v in s.items()}
        if isinstance(s, (list, tuple)):
            return type(s)(go(v) for v in s)
        if s is None:
            return None
        return next(it)
    return go(structure)


__all__ = ["tree_flatten", "tree_map", "tree_map_with_path",
           "tree_unflatten"]
