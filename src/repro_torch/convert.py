"""Weights and state carried across from the reference, through numpy.

Inputs are numpy trees, as ``jax.tree.map(np.asarray, ...)`` gives them:
dicts of arrays for parameters, and for a ``DSEState`` an object with the
state's fields (or a dict of them).  bfloat16 arrays (numpy's ``ml_dtypes``
bfloat16) keep their dtype.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .core.dse import DSEState
from .tree import tree_map

__all__ = ["params_from_numpy", "state_from_numpy", "tree_to_numpy"]


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)   # a writable copy: reference arrays are read-only
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Any, device) -> Any:
    """A numpy parameter tree as the port's tree of tensors on ``device``."""
    return tree_map(lambda a: _tensor(a, device), tree)


def state_from_numpy(state: Any, device) -> DSEState:
    """A reference ``DSEState`` (numpy leaves; either tracking layout) as the
    port's: absent buffers stay None, the step becomes a host int."""
    get = state.get if isinstance(state, dict) else lambda k: getattr(state, k, None)
    if get("comp") is not None:
        raise NotImplementedError(
            "gossip-compression state is not ported yet (ROADMAP queue 1 item 5)"
        )

    def tree(k):
        t = get(k)
        return None if t is None else params_from_numpy(t, device)

    return DSEState(
        params=tree("params"), x_ref=tree("x_ref"), v=tree("v"),
        y=tree("y"), h_prev=tree("h_prev"), z=tree("z"),
        step=int(np.asarray(get("step"))),
    )


def tree_to_numpy(tree: Any) -> Any:
    """Tensors back to float32/int numpy arrays (bf16 widened to float32)."""

    def one(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(one, tree)
