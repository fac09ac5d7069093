"""Weights and state carried across from the reference, through numpy.

Inputs are numpy trees, as ``jax.tree.map(np.asarray, ...)`` gives them:
dicts of arrays for parameters, and for an algorithm state an object with
the state's fields (or a dict of them).  bfloat16 arrays (numpy's
``ml_dtypes`` bfloat16) keep their dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .compression.base import ChannelState, Packed
from .core.baselines import GTHSGDState, GTState, MomentumState, SGDState, SlowMoState
from .core.dse import DSEState
from .tree import tree_map

__all__ = ["params_from_numpy", "state_from_numpy", "tree_to_numpy"]

# the port's state classes by name, which is also the reference's name
_STATE_CLASSES = {
    cls.__name__: cls
    for cls in (DSEState, SGDState, GTState, GTHSGDState, MomentumState, SlowMoState)
}


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)   # a writable copy: reference arrays are read-only
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Any, device) -> Any:
    """A numpy parameter tree as the port's tree of tensors on ``device``."""
    return tree_map(lambda a: _tensor(a, device), tree)


def _packed_from_numpy(p, device) -> Packed:
    """A reference ``Packed`` with numpy data as the port's: its meta names
    dtypes by string, the port's by ``torch.dtype``."""
    meta = tuple(getattr(torch, m) if isinstance(m, str) else m for m in p.meta)
    return Packed({k: _tensor(a, device) for k, a in p.data.items()}, meta=meta)


def _wire_from_numpy(tree, device) -> Any:
    """One buffer's wire entry: dicts of trees (``res``, ``hat``), per-node
    arrays (``age`` int32, ``sent`` bool) and in-flight ``Packed`` payloads."""
    if isinstance(tree, dict):
        return {k: _wire_from_numpy(v, device) for k, v in tree.items()}
    if type(tree).__name__ == "Packed":
        return _packed_from_numpy(tree, device)
    return _tensor(tree, device)


def _channel_state_from_numpy(comp, device) -> Optional[ChannelState]:
    """A reference ``ChannelState`` (per buffer, None or the channel's wire:
    ``res``, ``hat``, ``age``, ``sent``, ``fly``) as the port's.  The
    reference's PRNG key has no counterpart: the port's codec seeds come
    from ``comm_seed_fn`` by event number, which starts again at 0."""
    if comp is None:
        return None
    wire = tuple(None if w is None else _wire_from_numpy(w, device) for w in comp.wire)
    return ChannelState(wire=wire)


def state_from_numpy(state: Any, device) -> Any:
    """A reference algorithm state with numpy leaves as the port's.

    The port's class is the one named like the reference's (``DSEState``
    for a dict of fields).  Absent buffers stay None, the step becomes a
    host int, and a ``comp`` wire state is carried over."""
    if isinstance(state, dict):
        get = state.get
        cls = DSEState
    else:
        get = lambda k: getattr(state, k, None)  # noqa: E731
        cls = _STATE_CLASSES[type(state).__name__]
    out = {}
    for f in dataclasses.fields(cls):
        value = get(f.name)
        if f.name == "step":
            out["step"] = int(np.asarray(value))
        elif f.name == "comp":
            out["comp"] = _channel_state_from_numpy(value, device)
        else:
            out[f.name] = None if value is None else params_from_numpy(value, device)
    return cls(**out)


def tree_to_numpy(tree: Any) -> Any:
    """Tensors back to float32/int numpy arrays (bf16 widened to float32)."""

    def one(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(one, tree)
