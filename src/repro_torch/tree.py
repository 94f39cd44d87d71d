"""Nested dicts and lists of tensors, walked as ``jax.tree`` walks a
pytree: a dict's keys in sorted order, a list's or tuple's items in order,
anything else a leaf.  The training path's trees (parameters, gradients,
optimizer moments, checkpoints) are such trees, so their leaves come in the
reference's leaf order and their key paths are named as its checkpoint
store names them (``"layers/attn/wq/3"``)."""
from __future__ import annotations


def _children(tree):
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def leaves_with_paths(tree, prefix=()) -> list:
    """-> [(path, leaf)], each path a tuple of keys and indices."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [item for k, sub in kids
            for item in leaves_with_paths(sub, (*prefix, k))]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def keypaths(tree) -> list[str]:
    """Each leaf's path, its keys joined by ``/``."""
    return ["/".join(str(k) for k in path)
            for path, _ in leaves_with_paths(tree)]


def unflatten(like, new_leaves):
    """A tree of ``like``'s structure holding ``new_leaves`` in leaf order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of trees of its structure."""
    others = [leaves(t) for t in rest]
    return unflatten(tree, [fn(x, *(o[i] for o in others))
                            for i, x in enumerate(leaves(tree))])
