"""Nested dict/list parameter trees, flattened in the JAX package's order.

JAX flattens a dict in SORTED key order and a list/tuple in index order,
and treats ``None`` as an empty subtree. Wire record order and record
paths follow that flatten, so the port flattens the same way.

A path is a tuple of entries ``("d", key)`` for a dict key (str or int)
and ``("i", index)`` for a sequence index.
"""

from __future__ import annotations

from typing import Any, Callable

Pytree = Any
Path = tuple


def _children(node):
    if isinstance(node, dict):
        return [(("d", k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(("i", i), v) for i, v in enumerate(node)]
    return None


def flatten_with_path(
    tree: Pytree, is_leaf: Callable[[Any], bool] | None = None
) -> list[tuple[Path, Any]]:
    """(path, leaf) pairs in JAX flatten order; ``None`` subtrees vanish."""
    out: list[tuple[Path, Any]] = []

    def walk(node, path):
        if node is None:
            return
        kids = None if (is_leaf is not None and is_leaf(node)) else _children(node)
        if kids is None:
            out.append((path, node))
            return
        for entry, child in kids:
            walk(child, path + (entry,))

    walk(tree, ())
    return out


def tree_leaves(tree: Pytree, is_leaf: Callable[[Any], bool] | None = None) -> list:
    return [leaf for _, leaf in flatten_with_path(tree, is_leaf)]


def tree_map_with_path(
    fn: Callable[[Path, Any], Any],
    tree: Pytree,
    is_leaf: Callable[[Any], bool] | None = None,
) -> Pytree:
    """Rebuild ``tree`` with ``fn(path, leaf)`` at every leaf; dicts keep
    their keys, lists and tuples their type, ``None`` stays ``None``."""

    def walk(node, path):
        if node is None:
            return None
        if is_leaf is not None and is_leaf(node):
            return fn(path, node)
        if isinstance(node, dict):
            return {k: walk(node[k], path + (("d", k),)) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            items = [walk(v, path + (("i", i),)) for i, v in enumerate(node)]
            return type(node)(items) if isinstance(node, tuple) else items
        return fn(path, node)

    return walk(tree, ())


def tree_map(
    fn: Callable[[Any], Any],
    tree: Pytree,
    is_leaf: Callable[[Any], bool] | None = None,
) -> Pytree:
    return tree_map_with_path(lambda _, leaf: fn(leaf), tree, is_leaf)


def path_str(path: Path) -> str:
    """``repro.core.fttq._path_str``: keys and indices joined by ``/``."""
    return "/".join(str(key) for _, key in path)
