"""Parameter trees: nested dicts and lists of tensors, as the JAX package's
pytrees. ``tree_map`` and ``tree_leaves`` walk dicts in insertion order and
lists in order, so two trees of one structure line up leaf by leaf;
``tree_unflatten`` inverts ``tree_leaves``; ``value_and_grad``
differentiates over such a tree."""

from __future__ import annotations

import torch


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


def tree_unflatten(template, leaves):
    """A tree of ``template``'s structure holding ``leaves`` in
    ``tree_leaves``' order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def tree_leaves_like(template, tree) -> list:
    """``tree``'s leaves in ``template``'s order, dicts matched by key (a
    tree carried over from the JAX package has its keys sorted)."""
    return tree_leaves(tree_map(lambda _, x: x, template, tree))


def value_and_grad(loss_fn, params, *args):
    """``(loss, aux, grads)`` of ``loss_fn(params, *args) -> (loss, aux)``,
    ``grads`` over ``params``' tree. The parameters' own ``requires_grad``
    flags are left alone: autograd runs over detached views of them."""
    views = tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, aux = loss_fn(views, *args)
        grads = torch.autograd.grad(loss, tree_leaves(views))
    return loss.detach(), aux, tree_unflatten(params, grads)
