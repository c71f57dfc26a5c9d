"""Parameter trees: nested dicts and lists of tensors, as the JAX pytrees.

Leaves are visited in the reference's order: dict keys sorted, list items
by index.  Paths render as ``repro.ckpt.checkpoint`` renders them (a dict
key as itself, a list index as ``[i]``), joined by ``/``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Tree:
    """Apply ``fn`` leaf by leaf over trees of the same structure.  A node
    of ``tree`` for which ``is_leaf`` holds is a leaf, whatever its type
    (``rest`` is walked alongside down to it)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf)
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest), is_leaf=is_leaf)
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_flatten_with_path(tree: Tree, prefix: Tuple[str, ...] = ()
                           ) -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` in leaf order, paths like ``main/layers/[0]/w``."""
    if isinstance(tree, dict):
        out: List[Tuple[str, Any]] = []
        for k in sorted(tree):
            out.extend(tree_flatten_with_path(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, t in enumerate(tree):
            out.extend(tree_flatten_with_path(t, prefix + (f"[{i}]",)))
        return out
    return [("/".join(prefix), tree)]


def tree_leaves(tree: Tree) -> List[Any]:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_unflatten(like: Tree, leaves) -> Tree:
    """A tree shaped as ``like`` whose leaves are ``leaves``, in leaf order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
