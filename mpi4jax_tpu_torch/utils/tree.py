"""Parameter trees in the JAX package's leaf order.

The JAX package's parallel layers walk pytrees with ``jax.tree``: a dict's
values in sorted key order, a list's, a tuple's and a named tuple's in
order, and ``None`` as an empty node with no leaf.  Gradient buckets follow
that order (``parallel/dp.py``), so the port flattens its trees of tensors
the same way.  Anything that is not a dict, list, tuple or ``None`` is a
leaf.
"""

from __future__ import annotations


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree):
    """``(leaves, treedef)``: the leaves in ``jax.tree.flatten``'s order,
    and what ``unflatten`` needs to rebuild the tree."""
    leaves = []

    def walk(node):
        if node is None:
            return None
        if isinstance(node, dict):
            keys = sorted(node)
            return (dict, keys, [walk(node[k]) for k in keys])
        if _is_namedtuple(node):
            return (type(node), None, [walk(v) for v in node])
        if isinstance(node, (list, tuple)):
            return (type(node), None, [walk(v) for v in node])
        leaves.append(node)
        return "leaf"

    return leaves, walk(tree)


def unflatten(treedef, leaves):
    """The tree of ``treedef`` with ``leaves`` in flatten's order."""
    it = iter(leaves)

    def build(d):
        if d is None:
            return None
        if d == "leaf":
            return next(it)
        kind, keys, children = d
        vals = [build(c) for c in children]
        if kind is dict:
            return dict(zip(keys, vals))
        if issubclass(kind, tuple) and hasattr(kind, "_fields"):
            return kind(*vals)
        return kind(vals)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def leaves(tree) -> list:
    return flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure)."""
    flat, treedef = flatten(tree)
    others = [flatten(t)[0] for t in rest]
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])
