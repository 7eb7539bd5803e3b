"""Nested-dict trees: what ``jax.tree`` does for the reference's pytrees.

Leaves are tensors (or anything that is not a dict); dict keys are walked
in sorted order, as JAX flattens dicts, so sums over leaves and checkpoint
leaf numbering follow the reference's order.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leafwise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_leaves_with_path(tree, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """[(key path, leaf)] in sorted-key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_leaves_with_path(tree[k], path + (k,)))
        return out
    return [(path, tree)]


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def keystr(path: Tuple) -> str:
    """``['params']['conv0']['w']``: the reference's ``jax.tree_util.keystr``."""
    return "".join(f"[{k!r}]" for k in path)
