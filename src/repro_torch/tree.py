"""Parameter trees of the port: nested dicts of tensors.

The port's counterpart of the ``jax.tree`` functions the reference uses.  A
tree is a tensor (a leaf) or a dict whose values are trees; leaves are
visited in sorted key order, as ``jax.tree`` orders dict keys, so a flat
leaf list lines up with the reference's.  :func:`map_tensors` walks the
wider structures of the gossip wire (tuples, packed payloads, states).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

import torch

__all__ = ["tree_flatten", "tree_unflatten", "tree_leaves", "tree_map", "map_tensors"]

Tree = Any
TreeDef = Any    # None for a leaf, else a tuple of (key, child TreeDef)


def _walk(t: Tree, leaves: List[Any]) -> TreeDef:
    if isinstance(t, dict):
        return tuple((k, _walk(t[k], leaves)) for k in sorted(t))
    leaves.append(t)
    return None


def _build(d: TreeDef, it) -> Tree:
    if d is None:
        return next(it)
    return {k: _build(c, it) for k, c in d}


# the recursion is in module-level functions: a nested function that calls
# itself is a reference cycle, which would hold every leaf it touched (whole
# parameter and cache trees) until the garbage collector runs
def tree_flatten(tree: Tree) -> Tuple[List[Any], TreeDef]:
    """``(leaves, treedef)``; two trees share a structure iff treedefs are equal."""
    leaves: List[Any] = []
    return leaves, _walk(tree, leaves)


def tree_unflatten(treedef: TreeDef, leaves) -> Tree:
    return _build(treedef, iter(leaves))


def tree_leaves(tree: Tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` applied leafwise over trees of one structure."""
    leaves, treedef = tree_flatten(tree)
    others = []
    for r in rest:
        r_leaves, r_def = tree_flatten(r)
        if r_def != treedef:
            raise ValueError(f"tree structures differ ({r_def} vs {treedef})")
        others.append(r_leaves)
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def map_tensors(fn: Callable[[torch.Tensor], Any], obj: Any) -> Any:
    """``fn`` applied to every tensor of a nested structure of dicts,
    tuples, lists and dataclasses (packed payloads); anything else is kept
    as it is."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: map_tensors(fn, v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(map_tensors(fn, v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: map_tensors(fn, getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    return obj
