"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

Parameters, gradients, updates and labels are nested ``dict``s with tensor
(or label) leaves. Flattening visits dict keys in sorted order, exactly as
``jax.tree_util`` does, so leaf order (and with it the optimizer's bucket
order) matches the reference. ``None`` leaves are empty subtrees, as in
JAX: ``core.combine`` masks each sub-optimizer's view with them.
"""

from __future__ import annotations

from typing import Any, Callable

Path = tuple[str, ...]


def flatten_with_path(tree: Any, prefix: Path = ()) -> list[tuple[Path, Any]]:
    """``[(path, leaf), ...]`` in sorted-key order; ``None`` leaves skipped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out: list = []
        for key in sorted(tree):
            out += flatten_with_path(tree[key], prefix + (str(key),))
        return out
    return [(prefix, tree)]


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def map_with_path(fn: Callable, tree: Any, *rest: Any, prefix: Path = ()) -> Any:
    """Apply ``fn(path, leaf, *rest_leaves)`` over ``tree``'s structure.

    ``None`` leaves of ``tree`` stay ``None``; ``rest`` trees must share the
    structure (their leaves at ``None`` positions are not read).
    """
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {
            key: map_with_path(
                fn, tree[key], *(r[key] for r in rest), prefix=prefix + (str(key),)
            )
            for key in tree
        }
    return fn(prefix, tree, *rest)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    return map_with_path(lambda _, leaf, *r: fn(leaf, *r), tree, *rest)


def unflatten(items: list[tuple[Path, Any]]) -> dict:
    """Inverse of :func:`flatten_with_path` for dict trees."""
    out: dict = {}
    for path, leaf in items:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def path_str(path: Path) -> str:
    return "/".join(path)
