"""Trees of tensors: nested dicts, lists and tuples (NamedTuples included)
with tensors, arrays or scalars at the leaves — the port's counterpart of
``jax.tree``'s flatten and map, in the same leaf order (dict keys sorted,
sequences in order, ``None`` an empty subtree).  The optimizer sums its
global norm in this order, and checkpoints number their leaves by it, so a
checkpoint of either package restores in the other."""
from __future__ import annotations

from typing import Callable


def leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.flatten``'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def map(fn: Callable, tree):  # noqa: A001  (jax.tree.map's name)
    """``tree`` with every leaf replaced by ``fn(leaf)``, the leaves visited
    in :func:`leaves`' order; containers keep their type (a NamedTuple stays
    one, a dict comes back with its keys sorted)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map(fn, v) for v in tree)
    return fn(tree)
