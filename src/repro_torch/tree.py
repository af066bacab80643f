"""Minimal pytree helpers over nested dicts / lists / tuples of leaves.

The JAX package leans on ``jax.tree``; the port's parameters are plain
nested dicts of tensors and need only map / leaves / flatten. Dicts are
walked in insertion order (``jax.tree`` sorts keys; the order only has
to be consistent within the port). A tuple subclass whose class sets
``tree_leaf = True`` (``launch.sharding.P``) is a leaf, as a
``PartitionSpec`` is to ``jax.tree``.
"""

from __future__ import annotations

from typing import Any, Callable


def _is_seq(x: Any) -> bool:
    return isinstance(x, (list, tuple)) and not getattr(x, "tree_leaf", False)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over trees of identical structure."""
    if isinstance(tree, dict):
        for other in rest:
            if tree.keys() != other.keys():
                raise ValueError("tree_map: dict keys differ")
        return {
            k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()
        }
    if _is_seq(tree):
        for other in rest:
            if len(other) != len(tree):
                raise ValueError("tree_map: sequence lengths differ")
        out = [
            tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)
        ]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in tree_leaves(v)]
    if _is_seq(tree):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def tree_unflatten(like: Any, leaves: list) -> Any:
    """Rebuild a tree shaped as ``like`` from ``tree_leaves`` order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: too many leaves")
    return out


def tree_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``[(slash/joined/path, leaf), …]`` in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif _is_seq(tree):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    return [
        pl
        for k, v in items
        for pl in tree_paths(v, f"{prefix}/{k}" if prefix else str(k))
    ]


def tree_map_with_path(fn: Callable, tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` leaf-wise, ``path`` as ``tree_paths`` gives it."""
    if isinstance(tree, dict):
        return {
            k: tree_map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
            for k, v in tree.items()
        }
    if _is_seq(tree):
        out = [
            tree_map_with_path(fn, v, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(tree)
        ]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(prefix, tree)
