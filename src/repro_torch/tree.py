"""Maps over the port's parameter and cache trees: nested dicts and lists
(or tuples) with tensors at the leaves, the shape the reference keeps
its pytrees in.

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


__all__ = ["tree_map", "tree_map_with_path"]
