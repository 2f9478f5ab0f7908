"""Parameter trees: nested dicts (and lists and tuples) of tensors, walked
in the JAX package's tree order (dict keys sorted). Shared by the training
path and the rank group's collectives."""
from __future__ import annotations


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, lists and tuples, dict keys in sorted
    order (the JAX package's tree order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(tree, leaves):
    """Nested dicts of ``tree``'s structure holding ``leaves`` (an iterable
    in ``tree_leaves`` order) at its leaves."""
    it = iter(leaves)

    def put(node):
        if isinstance(node, dict):
            return {k: put(node[k]) for k in sorted(node)}
        return next(it)

    return put(tree)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)
