"""Gossip (mixing) for node-stacked trees: ``x_i <- sum_j w_ij x_j``.

Counterpart of ``repro.core.mixing``'s dense backends.  The (N x N) .
(N x d) fp32 contraction is a plain ``torch.matmul``; the reference leaves
it to XLA, outside any Pallas kernel.

``dense_mix`` closes over a static W; ``scheduled_dense_mix`` is the
scenario engine's variant, whose mix signature is ``(tree, ctx)`` with W_t
taken from the per-round :class:`~repro_torch.core.algorithm.RoundCtx`.
Both run through ``_dense_contract``, so a constant W_t is bit for bit the
static mix.  :class:`Rotation` describes one shift-structured gossip round
(the topology schedules build them); applying rotations, and the sharded
all-gather and collective-permute backends, belong to the sharded engine
(ROADMAP queue 1 item 8).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch

from ..tree import tree_map
from .topology import Topology

Tree = Any
MixFn = Callable[[Tree], Tree]

__all__ = ["dense_mix", "scheduled_dense_mix", "Rotation"]


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


def scheduled_dense_mix() -> Callable[[Tree, Any], Tree]:
    """Dense gossip with the round's mixing matrix taken from ``ctx.w`` (an
    fp32 (N, N) tensor on the state's device): the same contraction as
    :func:`dense_mix`, so a constant W_t is bit for bit the static mix."""

    def mix(tree: Tree, ctx) -> Tree:
        return _dense_contract(ctx.w, tree)

    return mix


@dataclasses.dataclass(frozen=True)
class Rotation:
    """One gossip rotation of a shift-structured topology: the self weight
    plus cyclic (shift, weight) pairs, ``x_i <- w_self x_i + sum_s w_s
    x_{(i+s) mod n}``.  The topology schedules expose these for the sharded
    engine's neighbor-only gossip; the dense engine mixes with W_t."""

    self_weight: float
    shifts: tuple[int, ...]
    weights: tuple[float, ...]

    @classmethod
    def from_topology(cls, topology: Topology) -> "Rotation":
        if not topology.shifts:
            raise ValueError(f"{topology.name} is not shift-structured")
        return cls(
            self_weight=topology.self_weight(),
            shifts=topology.shifts,
            weights=topology.shift_weights(),
        )
