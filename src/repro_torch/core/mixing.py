"""Gossip (mixing) for node-stacked trees: ``x_i <- sum_j w_ij x_j``.

Counterpart of ``repro.core.mixing.dense_mix``.  The (N x N) . (N x d) fp32
contraction is a plain ``torch.matmul``; the reference leaves it to XLA,
outside any Pallas kernel.  The sharded backends (all-gather, ring
collective-permute) and the scheduled variants are later slices.
"""
from __future__ import annotations

import functools
from typing import Any, Callable

import numpy as np
import torch

from ..tree import tree_map

Tree = Any
MixFn = Callable[[Tree], Tree]

__all__ = ["dense_mix"]


def _dense_contract(w: torch.Tensor, tree: Tree) -> Tree:
    """The one dense contraction: leaf (N, ...) -> W @ leaf, fp32 accumulate."""

    def one(x):
        out = torch.matmul(w, x.reshape(x.shape[0], -1).float())
        return out.reshape(x.shape).to(x.dtype)

    return tree_map(one, tree)


def dense_mix(w: np.ndarray, device=None) -> MixFn:
    """Mixing for node-stacked trees: leaf shape (N, ...) -> (N, ...)."""
    w = torch.as_tensor(np.asarray(w), dtype=torch.float32, device=device)
    return functools.partial(_dense_contract, w)
