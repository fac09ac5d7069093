"""Minimal tree optimizers (optax-style init / update pairs) over trees of
tensors.

Counterpart of ``repro.optim.optimizers``: the inner optimizers of the
baselines and the centralized references of the benchmarks.  The step
counter ``t`` is a host int, since the port's schedules take host scalars.
The reference's quirks are kept: ``sgd`` evaluates a callable lr at
``t = 0``, and ``adam`` keeps fp32 moments whatever the parameters' dtype.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch

from ..tree import tree_leaves, tree_map

Tree = Any

__all__ = ["Optimizer", "sgd", "momentum", "adam", "apply_updates", "global_norm",
           "clip_by_global_norm"]


class Optimizer(NamedTuple):
    init: Callable[[Tree], Tree]
    update: Callable[..., Tuple[Tree, Tree]]   # (grads, state, params) -> (updates, state)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree: Tree) -> torch.Tensor:
    """The fp32 2-norm of every leaf of ``tree`` together (a 0-d tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def clip_by_global_norm(tree: Tree, max_norm: float) -> Tree:
    """``tree`` scaled by ``min(1, max_norm / (norm + 1e-9))`` (a leaf of a
    narrower float type promotes to fp32, as in the reference)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda x: x.to(torch.promote_types(x.dtype, scale.dtype)) * scale, tree)


def _lr(lr, t) -> float:
    return lr(t) if callable(lr) else lr


def sgd(lr) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params=None):
        return tree_map(lambda x: -_lr(lr, 0) * x, grads), ()

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"m": tree_map(torch.zeros_like, params), "t": 0}

    def update(grads, state, params=None):
        m = tree_map(lambda mm, g: beta * mm + g, state["m"], grads)
        d = tree_map(lambda mm, g: beta * mm + g, m, grads) if nesterov else m
        step = _lr(lr, state["t"])
        return tree_map(lambda x: -step * x, d), {"m": m, "t": state["t"] + 1}

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    def init(params):
        z = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                     params)
        return {"m": z, "v": tree_map(torch.clone, z), "t": 0}

    def update(grads, state, params=None):
        t = state["t"] + 1
        m = tree_map(lambda mm, g: b1 * mm + (1 - b1) * g.float(), state["m"], grads)
        v = tree_map(lambda vv, g: b2 * vv + (1 - b2) * torch.square(g.float()),
                     state["v"], grads)
        # the bias corrections in fp32, as the reference computes them
        c1 = float(np.float32(1) - np.float32(b1) ** np.float32(t))
        c2 = float(np.float32(1) - np.float32(b2) ** np.float32(t))
        step = _lr(lr, t)
        upd = tree_map(lambda mm, vv: -step * (mm / c1) / (torch.sqrt(vv / c2) + eps), m, v)
        return upd, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)
