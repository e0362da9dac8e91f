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


def _flatten_into(out: list, node, path: Path, is_leaf) -> None:
    if node is None:
        return
    kids = None if (is_leaf is not None and is_leaf(node)) else _children(node)
    if kids is None:
        out.append((path, node))
        return
    for entry, child in kids:
        _flatten_into(out, child, path + (entry,), is_leaf)


def flatten_with_path(
    tree: Pytree, is_leaf: Callable[[Any], bool] | None = None
) -> list[tuple[Path, Any]]:
    """(path, leaf) pairs in JAX flatten order; ``None`` subtrees vanish."""
    out: list[tuple[Path, Any]] = []
    _flatten_into(out, tree, (), is_leaf)
    return out


def tree_leaves(tree: Pytree, is_leaf: Callable[[Any], bool] | None = None) -> list:
    return [leaf for _, leaf in flatten_with_path(tree, is_leaf)]


def _map(fn, node, path: Path, is_leaf):
    if node is None:
        return None
    if is_leaf is not None and is_leaf(node):
        return fn(path, node)
    if isinstance(node, dict):
        return {k: _map(fn, node[k], path + (("d", k),), is_leaf) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        items = [_map(fn, v, path + (("i", i),), is_leaf) for i, v in enumerate(node)]
        return type(node)(items) if isinstance(node, tuple) else items
    return fn(path, node)


def tree_map_with_path(
    fn: Callable[[Path, Any], Any],
    tree: Pytree,
    is_leaf: Callable[[Any], bool] | None = None,
) -> Pytree:
    """Rebuild ``tree`` with ``fn(path, leaf)`` at every leaf; dicts keep
    their keys, lists and tuples their type, ``None`` stays ``None``. (The
    walkers are module functions, not recursive closures: a closure that
    calls itself is a reference cycle, which would keep whatever ``fn``
    holds, such as tensors, alive until the garbage collector runs.)"""
    return _map(fn, tree, (), is_leaf)


def tree_map(
    fn: Callable[[Any], Any],
    tree: Pytree,
    is_leaf: Callable[[Any], bool] | None = None,
) -> Pytree:
    return tree_map_with_path(lambda _, leaf: fn(leaf), tree, is_leaf)


def path_str(path: Path) -> str:
    """``repro.core.fttq._path_str``: keys and indices joined by ``/``."""
    return "/".join(str(key) for _, key in path)
