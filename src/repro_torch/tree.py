"""Flattening of the port's parameter and state trees.

A tree is nested dicts, lists, tuples and NamedTuples with tensors (or
other objects) at the leaves.  ``tree_flatten`` lists the leaves in the
order JAX flattens the same structure (dict keys sorted, sequences in
order), with their path names (``"blocks/3/attn/wq"``);
``tree_unflatten`` puts a list of leaves back into a tree's structure.
"""
from __future__ import annotations


def tree_flatten(tree, prefix=""):
    """[(path name, leaf)] in JAX's order."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += tree_flatten(tree[key], f"{prefix}{key}/")
        return out
    if isinstance(tree, (list, tuple)):
        fields = getattr(tree, "_fields", None)
        out = []
        for i, item in enumerate(tree):
            out += tree_flatten(item, f"{prefix}{fields[i] if fields else i}/")
        return out
    return [(prefix.rstrip("/"), tree)]


def tree_leaves(tree):
    """The leaves of ``tree`` in ``tree_flatten``'s order."""
    return [leaf for _, leaf in tree_flatten(tree)]


def tree_unflatten(like, leaves):
    """``like``'s structure with ``leaves`` (a list, in ``tree_flatten``'s
    order) at its leaves."""
    it = iter(leaves)
    out = _fill(like, it)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


def _fill(like, it):
    if isinstance(like, dict):
        return {key: _fill(like[key], it) for key in sorted(like)}
    if isinstance(like, (list, tuple)):
        items = [_fill(item, it) for item in like]
        if hasattr(like, "_fields"):
            return type(like)(*items)
        return type(like)(items)
    try:
        return next(it)
    except StopIteration:
        raise ValueError("tree_unflatten: fewer leaves than the tree "
                         "holds") from None
