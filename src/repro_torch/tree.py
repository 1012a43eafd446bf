"""Nested containers of tensors ("trees"), walked in the reference's order.

The port keeps parameters and optimizer state as plain dicts, lists and
NamedTuples of tensors. These helpers visit their leaves in the order
``jax.tree.leaves`` visits the reference's pytrees (dict keys sorted,
sequences and NamedTuple fields in order, ``None`` an empty subtree), so
sums over leaves run in the reference's order and checkpoint keys are the
reference's.
"""
from __future__ import annotations

import torch

__all__ = ["leaves", "leaves_with_paths", "tree_map", "unflatten"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_paths(tree, path: tuple = ()) -> list[tuple[tuple, torch.Tensor]]:
    """``[(path, leaf), ...]``; a path holds dict keys, sequence indices and
    ``"." + field`` for a NamedTuple field (JAX's spelling of its keys)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in leaves_with_paths(tree[k], path + (k,))]
    if _is_namedtuple(tree):
        return [item for f in tree._fields for item in leaves_with_paths(getattr(tree, f), path + ("." + f,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree) for item in leaves_with_paths(v, path + (i,))]
    return [(path, tree)]


def leaves(tree) -> list[torch.Tensor]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn, tree, *rest):
    """A tree of ``tree``'s structure whose leaves are ``fn(leaf, *others)``,
    ``others`` the leaves at the same place in ``rest``; ``fn`` is called
    on the leaves in `leaves` order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(tree, new_leaves):
    """A tree of ``tree``'s structure holding ``new_leaves`` (in `leaves` order)."""
    it = iter(new_leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
