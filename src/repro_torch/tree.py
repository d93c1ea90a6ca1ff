"""Trees of tensors: nested dicts and NamedTuples, walked in JAX's
flattening order (dict keys sorted, NamedTuple fields in order, a None no
leaf).

The order decides the global norm's summation order, the gradient list of
a train step and a checkpoint's path keys, so every walk of a tree in the
port goes through this module.
"""
from __future__ import annotations

from typing import Any, List, Tuple


def _is_node(tree) -> bool:
    return isinstance(tree, dict) or (isinstance(tree, tuple)
                                      and hasattr(tree, "_fields"))


def _children(tree) -> List[Tuple[str, Any]]:
    """(name, child) pairs of a node in JAX's order."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    return list(zip(tree._fields, tree))


def tree_items(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path key, leaf) pairs in JAX's order; a path joins the names from
    the root with ``/`` (``m/embed/table``)."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for name, child in _children(tree):
        out.extend(tree_items(child, f"{prefix}/{name}" if prefix else name))
    return out


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's order."""
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of trees of one structure (``rest`` indexed
    like ``tree``); None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_node(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    return fn(tree, *rest)


def tree_unflatten(tree, leaves):
    """``leaves`` (in ``tree_leaves`` order) in ``tree``'s structure."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if _is_node(node):
            return type(node)(*(build(v) for v in node))
        return next(it)

    return build(tree)
