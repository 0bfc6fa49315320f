"""Parameter trees: nested dicts and lists of tensors, as the JAX package's
pytrees. ``tree_map`` and ``tree_leaves`` walk dicts in insertion order and
lists in order, so two trees of one structure line up leaf by leaf."""

from __future__ import annotations


def tree_map(fn, tree, *rest):
    """The tree of ``fn(leaf, *leaves_of_rest)``; ``rest`` share ``tree``'s
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out
