"""Minimal pytree helpers over tensors, dicts, tuples and lists (the port's
stand-in for ``jax.tree``)."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


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


def tree_unflatten_like(tree, leaves: list):
    """A tree shaped like ``tree`` whose leaves are ``leaves``, in
    :func:`tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def ravel(tree) -> Tuple[torch.Tensor, Callable]:
    """Flatten a tree of tensors into one 1-D tensor (leaves in
    :func:`tree_leaves` order, each row-major), and the inverse, which
    restores every leaf's shape and dtype — the port's
    ``jax.flatten_util.ravel_pytree``, except that dict leaves come in
    insertion order (JAX sorts the keys).  The flat vector takes the
    leaves' common dtype (torch's type promotion)."""
    leaves = tree_leaves(tree)
    shapes = [t.shape for t in leaves]
    dtypes = [t.dtype for t in leaves]
    sizes = [t.numel() for t in leaves]
    flat = torch.cat([t.reshape(-1) for t in leaves])

    def unravel(v: torch.Tensor):
        parts = torch.split(v, sizes)
        return tree_unflatten_like(tree, [p.reshape(shape).to(dt) for p, shape, dt
                                          in zip(parts, shapes, dtypes)])

    return flat, unravel
