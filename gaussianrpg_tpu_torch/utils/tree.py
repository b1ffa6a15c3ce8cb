"""Nested containers of tensors (the JAX package's pytrees): dicts and
dataclasses of tensors, mapped leaf by leaf. The first tree sets the
structure; the others must have the same keys and fields (leaves of a
learning-rate tree may be floats)."""
from __future__ import annotations

import dataclasses


def _is_node(x) -> bool:
    return isinstance(x, dict) or (dataclasses.is_dataclass(x)
                                   and not isinstance(x, type))


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_node(tree):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if _is_node(tree):
        return [x for f in dataclasses.fields(tree)
                for x in tree_leaves(getattr(tree, f.name))]
    return [tree]


def tree_unflatten(tree, leaves):
    """A tree of `tree`'s structure holding `leaves` in tree_leaves order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
