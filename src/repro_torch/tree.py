"""Trees of tensors as the reference's pytrees: the few ``jax.tree_util``
functions the LM substrate uses, on dicts, lists, tuples and NamedTuples.

A dict flattens in sorted key order, as JAX flattens one; anything that is
not one of those containers is a leaf.  :class:`Stacked` is the one node
of the port's own: the per-layer tensors of a leaf that the reference
holds as one stacked ``[L, ...]`` array (``scan_layers=True``).  The port
keeps a tensor a layer, so that each layer's update can run in place;
:func:`tree_map` maps over its members and keeps the node.
"""
from __future__ import annotations

from typing import Any, Callable


class Stacked(list):
    """The L per-layer tensors of one scanned leaf, in layer order: the
    reference's ``[L, ...]`` array held apart.  Its stacked shape is
    ``(L, *member.shape)``; checkpoints stack it on the host."""

    @property
    def shape(self) -> tuple[int, ...]:
        return (len(self), *self[0].shape)


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> list[tuple[str, Any]] | None:
    """(path key, child) of a container in JAX's order, or None for a leaf.
    The keys are the strings the reference's checkpoint names print: a
    dict's key, a sequence's index and ``.field`` for a NamedTuple's."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", v) for f, v in zip(node._fields, node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _rebuild(node, children: list):
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if _is_namedtuple(node):
        return type(node)(*children)
    if isinstance(node, Stacked):
        return Stacked(children)
    return type(node)(children)


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable[[Any], bool] | None = None):
    """``fn(leaf, *matching leaves of rest)`` over every leaf of ``tree``,
    in JAX's order, keeping the structure (a dict comes back with its keys
    sorted); a node for which ``is_leaf`` is true is a leaf.  ``rest``
    must have ``tree``'s structure."""
    kids = None if is_leaf is not None and is_leaf(tree) else _children(tree)
    if kids is None:
        return fn(tree, *rest)
    others = [_children(r) for r in rest]
    return _rebuild(tree, [tree_map(fn, v, *(o[i][1] for o in others), is_leaf=is_leaf)
                           for i, (_, v) in enumerate(kids)])


def tree_leaves_with_path(tree, is_leaf: Callable[[Any], bool] | None = None,
                          _path: tuple[str, ...] = ()) -> list[tuple[tuple[str, ...], Any]]:
    """(path of keys, leaf) for every leaf in JAX's order; a node for which
    ``is_leaf`` is true is a leaf."""
    kids = None if is_leaf is not None and is_leaf(tree) else _children(tree)
    if kids is None:
        return [(_path, tree)]
    return [item for k, v in kids for item in tree_leaves_with_path(v, is_leaf, (*_path, k))]


def tree_leaves(tree, is_leaf: Callable[[Any], bool] | None = None) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree, is_leaf)]


def tree_unflatten_like(tree, leaves: list, is_leaf: Callable[[Any], bool] | None = None):
    """``tree``'s structure with its leaves replaced, in order, by ``leaves``
    (a node for which ``is_leaf`` is true is a leaf)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree, is_leaf=is_leaf)


def treedef_str(tree) -> str:
    """The string ``jax.tree_util.tree_structure`` gives for the same tree
    (a :class:`Stacked` node is one leaf, as the reference's array is)."""
    def walk(node) -> str:
        if isinstance(node, Stacked):
            return "*"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}" for k in sorted(node)) + "}"
        if _is_namedtuple(node):
            return (f"CustomNode(namedtuple[{type(node).__name__}], ["
                    + ", ".join(walk(v) for v in node) + "])")
        if isinstance(node, tuple):
            return "(" + ", ".join(walk(v) for v in node) + ("," if len(node) == 1 else "") + ")"
        if isinstance(node, list):
            return "[" + ", ".join(walk(v) for v in node) + "]"
        return "*"
    return f"PyTreeDef({walk(tree)})"
