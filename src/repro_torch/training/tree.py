"""Walks over the nested dicts and lists that hold the port's params and
train state, in the order ``jax.tree_util`` walks the reference's: dict
keys sorted, sequences by index.  The order matters where floats are
summed across leaves (the global gradient norm) and names each leaf in a
checkpoint."""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return []


def _is_leaf(tree) -> bool:
    return not isinstance(tree, (dict, list, tuple))


def tree_leaves_with_path(tree, prefix: Tuple[str, ...] = ()
                          ) -> List[Tuple[Tuple[str, ...], Any]]:
    """``[(path, leaf), ...]`` in the reference's order."""
    if _is_leaf(tree):
        return [(prefix, tree)]
    return [item for key, child in _children(tree)
            for item in tree_leaves_with_path(child, prefix + (key,))]


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure: dicts stay dicts, lists lists.  The
    leaves are visited in :func:`tree_leaves`' order, so a list of values
    in that order can be put back with ``tree_map(lambda _: next(it), t)``."""
    if _is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                      for i, v in enumerate(tree))
