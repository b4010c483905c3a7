"""Nested dicts, tuples and lists of tensors, walked in the reference's
leaf order (``jax.tree`` flattens dicts by sorted key, a NamedTuple by its
fields in order)."""
from __future__ import annotations

from typing import Any, Callable


def _rebuild(like: Any, children) -> Any:
    """A tuple or list of ``like``'s type holding ``children``; a
    NamedTuple takes them as its fields."""
    if hasattr(like, "_fields"):
        return type(like)(*children)
    return type(like)(children)


def child_keys(tree: Any) -> list:
    """The path keys of a tuple's or list's children: a NamedTuple's field
    names (jax's ``GetAttrKey`` names, so an ``AdamWState`` under ``opt``
    is ``opt/step``, ``opt/m/...``), else the indices."""
    fields = getattr(tree, "_fields", None)
    if fields is not None:
        return list(fields)
    return [str(i) for i in range(len(tree))]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the same leaves of the
    ``rest`` trees, which share its structure): dicts by sorted key (the
    reference's leaf order), tuples (NamedTuples too) and lists by
    position; anything else is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return _rebuild(tree, [tree_map(fn, v, *(r[i] for r in rest))
                               for i, v in enumerate(tree)])
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any, *rest: Any,
                       prefix: str = "") -> Any:
    """:func:`tree_map` with ``fn(path, leaf, *rest_leaves)``: ``path``
    joins the dict keys, NamedTuple field names and sequence indices down
    to the leaf with ``/`` (``blocks/0/mixer/wq``, ``opt/m/embed``), as the
    reference's sharding rules and checkpoints name a leaf."""
    def down(key) -> str:
        return f"{prefix}/{key}" if prefix else str(key)

    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest),
                                      prefix=down(k))
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return _rebuild(tree, [
            tree_map_with_path(fn, v, *(r[i] for r in rest), prefix=down(key))
            for i, (key, v) in enumerate(zip(child_keys(tree), tree))])
    return fn(prefix, tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like: Any, leaves) -> Any:
    """``like``'s structure holding ``leaves`` (in :func:`tree_leaves`'s
    order)."""
    leaves = list(leaves)
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if len(leaves) != len(tree_leaves(like)):
        raise ValueError(f"{len(leaves)} leaves for a tree of "
                         f"{len(tree_leaves(like))}")
    return out


def tree_pick(tree: Any, like: Any, i: int) -> Any:
    """Element ``i`` of every tuple leaf of ``tree``, which has the
    structure of ``like`` down to those tuples."""
    if isinstance(like, dict):
        return {k: tree_pick(tree[k], v, i) for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return _rebuild(like, [tree_pick(t, v, i)
                               for t, v in zip(tree, like)])
    return tree[i]
