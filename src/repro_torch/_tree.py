"""Nested containers of tensors (the reference's pytrees), in the reference's
order: dict keys sorted, lists and tuples by index, anything else a leaf."""
from __future__ import annotations


def flatten(tree, prefix: tuple = ()) -> list[tuple[tuple, object]]:
    """(path, leaf) pairs in ``jax.tree.flatten``'s order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in flatten(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, x in enumerate(tree) for pl in flatten(x, prefix + (i,))]
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(proto, new_leaves) -> object:
    """``proto``'s structure with its leaves replaced, in flatten order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(proto)
    if next(it, None) is not None:
        raise ValueError("more leaves than the prototype holds")
    return out


def tree_map(fn, tree):
    return unflatten(tree, [fn(x) for x in leaves(tree)])
