"""Minimal pytree helpers over tensors, dicts, tuples and lists (the port's
stand-in for ``jax.tree``)."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leaf-wise over ``tree`` and structurally identical
    ``rest`` trees."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, path: str = ""):
    """Like :func:`tree_map` with ``fn(path, leaf)``; paths join dict keys
    and sequence indices with ``/`` (the reference checkpoint's keys)."""
    join = (lambda k: f"{path}/{k}") if path else str
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, v, join(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_leaves_with_path(tree) -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []
    tree_map_with_path(lambda p, x: out.append((p, x)), tree)
    return out


def tree_leaves(tree) -> list:
    return [x for _, x in tree_leaves_with_path(tree)]
