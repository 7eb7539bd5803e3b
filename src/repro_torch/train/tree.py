"""Nested trees of dicts, tuples and lists: what ``jax.tree`` does for the
reference's pytrees.

Dicts, tuples and lists are nodes and everything else is a leaf. Dict keys
are walked in sorted order, as JAX flattens dicts, and sequences in index
order, so sums over leaves and checkpoint leaf numbering follow the
reference's order. An empty tuple (the LM's ``tail`` where an arch has
none) holds no leaves, as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_node(tree, is_leaf=None) -> bool:
    return isinstance(tree, (dict, tuple, list)) and not (is_leaf and is_leaf(tree))


def tree_map_with_path(fn: Callable, tree, *rest, path: Tuple = (), is_leaf=None):
    """``fn(path, leaf, *rest_leaves)`` over trees of one structure
    (``tree``'s); ``path`` as in `tree_leaves_with_path`. ``is_leaf(x)``
    true stops the walk at ``x`` (as JAX's ``is_leaf``)."""
    if not _is_node(tree, is_leaf):
        return fn(path, tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest), path=path + (k,),
                                      is_leaf=is_leaf)
                for k in tree}
    return type(tree)(tree_map_with_path(fn, t, *(r[i] for r in rest), path=path + (i,),
                                         is_leaf=is_leaf)
                      for i, t in enumerate(tree))


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leafwise over trees of one structure (``tree``'s)."""
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def tree_leaves_with_path(tree, path: Tuple = (), is_leaf=None) -> List[Tuple[Tuple, Any]]:
    """[(key path, leaf)]: dict keys sorted, sequences in index order (an
    index enters the path as an int)."""
    if not _is_node(tree, is_leaf):
        return [(path, tree)]
    items = sorted(tree.items()) if isinstance(tree, dict) else enumerate(tree)
    out = []
    for k, sub in items:
        out.extend(tree_leaves_with_path(sub, path + (k,), is_leaf))
    return out


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def keystr(path: Tuple) -> str:
    """``['params']['tail'][0]['norm1']``: the reference's
    ``jax.tree_util.keystr`` (a dict key as its repr, a sequence index bare)."""
    return "".join(f"[{k!r}]" for k in path)
