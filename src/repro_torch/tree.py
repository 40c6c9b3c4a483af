"""Nested dicts and lists of tensors: the port's counterpart of ``jax.tree``
for the parameter, gradient and optimizer trees.

A node is a dict (its keys taken in sorted order, as ``jax.tree`` takes
them), a list or a tuple; anything else is a leaf.  A leaf's path joins its
keys and indices with ``/`` (``layers/0/attn/wq/w``), as the reference's
checkpointer names its arrays.
"""
from __future__ import annotations

__all__ = ["flatten", "leaves", "tree_map", "unflatten"]


def _walk(tree, path):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    else:
        yield path, tree


def flatten(tree) -> tuple[list[str], list]:
    """(paths, leaves) in the tree's order."""
    pairs = list(_walk(tree, ()))
    return ["/".join(p) for p, _ in pairs], [v for _, v in pairs]


def leaves(tree) -> list:
    return [v for _, v in _walk(tree, ())]


def unflatten(template, new_leaves):
    """``template``'s structure with its leaves replaced, in order, by
    ``new_leaves``."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    out = build(template)
    if next(it, it) is not it:
        raise ValueError("more leaves than the template has")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
