"""Weights and state carried across from the reference, through numpy.

Inputs are numpy trees, as ``jax.tree.map(np.asarray, ...)`` gives them:
dicts of arrays for parameters and for a model's decode caches, and for an
algorithm state an object with the state's fields (or a dict of them).  bfloat16 arrays (numpy's
``ml_dtypes`` bfloat16) keep their dtype; tensors are taken as they are.
:func:`state_from_checkpoint` reads an algorithm state from the nested dict
``repro_torch.checkpoint.load_checkpoint`` gives for either package's
checkpoint.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Any, Dict, Optional

import numpy as np
import torch

from .compression.base import ChannelState, Packed
from .core.baselines import GTHSGDState, GTState, MomentumState, SGDState, SlowMoState
from .core.dse import DSEState
from .tree import tree_map

__all__ = [
    "params_from_numpy", "cache_from_numpy", "state_from_numpy", "state_from_checkpoint",
    "tree_to_numpy",
]

# the port's state classes by name, which is also the reference's name
_STATE_CLASSES = {
    cls.__name__: cls
    for cls in (DSEState, SGDState, GTState, GTHSGDState, MomentumState, SlowMoState)
}


def _tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.array(a)   # a writable copy: reference arrays are read-only
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Any, device) -> Any:
    """A numpy parameter tree as the port's tree of tensors on ``device``:
    every leaf as it is, the stacked ``(repeats, ...)`` block leaves (a MoE
    block's ``(repeats, E, d, f)`` experts among them) and a shared block's
    single copy alike."""
    return tree_map(lambda a: _tensor(a, device), tree)


def cache_from_numpy(caches: Any, device) -> Any:
    """A reference model's decode caches as the port's, per block element
    ``b{i}`` stacked over repeats: an ``{"attn": {"k", "v", "pos"}}`` dict,
    k and v in their dtype and ``pos`` int32 (-1 marks an empty slot), an
    ``{"rwkv": {"wkv", "shift_t", "shift_c"}}`` dict, the state fp32 and the
    token shifts in their dtype, or a ``{"mamba": {"conv", "ssm"}}`` dict,
    the conv window in its dtype and the SSM state fp32."""
    out = {}
    for key, one in caches.items():
        for kind, state, names in (("rwkv", "wkv", ("wkv", "shift_t", "shift_c")),
                                   ("mamba", "ssm", ("conv", "ssm"))):
            if kind in one:
                dtype = np.asarray(one[kind][state]).dtype
                if dtype != np.float32:
                    raise ValueError(f"{key}: the {kind} state must be float32, got {dtype}")
                out[key] = {kind: {name: _tensor(one[kind][name], device) for name in names}}
        if key in out:
            continue
        attn = one["attn"]
        pos = np.asarray(attn["pos"])
        if pos.dtype != np.int32:
            raise ValueError(f"{key}: cache positions must be int32, got {pos.dtype}")
        out[key] = {"attn": {name: _tensor(attn[name], device) for name in ("k", "v", "pos")}}
    return out


def _packed_from_numpy(p, device) -> Packed:
    """A reference ``Packed`` with numpy data as the port's: its meta names
    dtypes by string, the port's by ``torch.dtype``."""
    meta = tuple(getattr(torch, m) if isinstance(m, str) else m for m in p.meta)
    return Packed({k: _tensor(a, device) for k, a in p.data.items()}, meta=meta)


def _wire_from_numpy(tree, device) -> Any:
    """One buffer's wire entry: dicts of trees (``res``, ``hat``), per-node
    arrays (``age`` int32, ``sent`` bool), in-flight ``Packed`` payloads and
    the sharded engine's per-shift tuples (``nbr``, ``rolled``,
    ``rolled_sent``)."""
    if isinstance(tree, dict):
        return {k: _wire_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_wire_from_numpy(v, device) for v in tree)
    if type(tree).__name__ == "Packed":
        return _packed_from_numpy(tree, device)
    return _tensor(tree, device)


def _channel_state_from_numpy(comp, device) -> Optional[ChannelState]:
    """A reference ``ChannelState`` (per buffer, None or the channel's wire:
    ``res``, ``hat``, ``age``, ``sent``, ``fly``) as the port's.  The
    reference's PRNG key has no counterpart: the port's codec seeds come
    from ``comm_seed_fn`` by event number, which starts again at 0 (the
    port's own ``event`` is kept where the input has one)."""
    if comp is None:
        return None
    wire = tuple(None if w is None else _wire_from_numpy(w, device) for w in comp.wire)
    return ChannelState(wire=wire, event=int(getattr(comp, "event", 0)))


def state_from_numpy(state: Any, device) -> Any:
    """A reference algorithm state with numpy leaves as the port's.

    The port's class is the one named like the reference's (``DSEState``
    for a dict of fields).  Absent buffers stay None, the step becomes a
    host int, and a ``comp`` wire state is carried over."""
    if isinstance(state, dict):
        return _state_of(DSEState, state.get, device)
    return _state_of(_STATE_CLASSES[type(state).__name__],
                     lambda k: getattr(state, k, None), device)


def _state_of(cls, get, device) -> Any:
    out = {}
    for f in dataclasses.fields(cls):
        value = get(f.name)
        if f.name == "step":
            out["step"] = int(value)
        elif f.name == "comp":
            out["comp"] = _channel_state_from_numpy(value, device)
        else:
            out[f.name] = None if value is None else params_from_numpy(value, device)
    return cls(**out)


def state_from_checkpoint(tree: Dict[str, Any], device) -> Any:
    """An algorithm state from a checkpoint's nested dict (``load_checkpoint``
    without ``like``, of a reference or a port checkpoint) on ``device``.

    The state class is the smallest whose fields hold every saved field
    (``DSEState`` for DSE-MVR / DSE-SGD, ``GTHSGDState`` for GT-HSGD, ...).
    A wire tuple ends at its last saved buffer (buffers after it hold no
    wire).  A reference ``.comp/.key`` is read past, as in
    :func:`state_from_numpy`; an in-flight ``Packed`` payload (overlap)
    needs its codec's meta, which only ``load_checkpoint(..., like=state)``
    has."""
    fields = {k.lstrip("."): v for k, v in tree.items()}
    comp = fields.get("comp")
    if comp is not None:
        wire = comp.get(".wire", {})
        n = max((int(i) for i in wire), default=-1) + 1
        _reject_payloads(wire)
        fields["comp"] = SimpleNamespace(
            wire=tuple(wire.get(str(i)) for i in range(n)), event=int(comp.get(".event", 0)))
    fitting = [c for c in _STATE_CLASSES.values()
               if set(fields) <= {f.name for f in dataclasses.fields(c)}]
    if not fitting:
        raise ValueError(f"no state class holds the fields {sorted(fields)}")
    cls = min(fitting, key=lambda c: len(dataclasses.fields(c)))
    return _state_of(cls, fields.get, device)


def _reject_payloads(tree) -> None:
    if isinstance(tree, dict):
        if ".data" in tree:
            raise ValueError(
                "the checkpoint holds an in-flight Packed payload; load it with "
                "load_checkpoint(..., like=state), which carries the codec's meta"
            )
        for v in tree.values():
            _reject_payloads(v)


def tree_to_numpy(tree: Any) -> Any:
    """Tensors back to float32/int numpy arrays (bf16 widened to float32)."""

    def one(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(one, tree)
