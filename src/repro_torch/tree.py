"""Nested dicts, tuples and lists of tensors, walked in the reference's
leaf order (``jax.tree`` flattens dicts by sorted key)."""
from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the same leaves of the
    ``rest`` trees, which share its structure): dicts by sorted key (the
    reference's leaf order), tuples and lists by position; anything else
    is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_pick(tree: Any, like: Any, i: int) -> Any:
    """Element ``i`` of every tuple leaf of ``tree``, which has the
    structure of ``like`` down to those tuples."""
    if isinstance(like, dict):
        return {k: tree_pick(tree[k], v, i) for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(tree_pick(t, v, i) for t, v in zip(tree, like))
    return tree[i]
