"""Gossip channels: HOW a communication event moves on the wire.

Counterpart of ``repro.compression.channels`` for the dense engine.  A
communication event composes three declarative axes:

  * the codec (``Compressor``, ``base.py``): the message representation;
  * the channel (here): the gossip protocol and its per-buffer wire state;
  * the transport (:class:`Transport`): the engine's delivery, here the
    Simulator's dense W contraction of the locally decoded message.

Ported: :class:`SyncChannel` (every node encodes its value every round;
error-feedback residuals are the only wire state; no codec or identity is a
pass-through).  ``"choco"`` and ``"async"`` are registered names that raise
``NotImplementedError``, and so do per-buffer channel mappings and
overlap (``core/algorithm.py``): ROADMAP queue 1 item 5.

:class:`ChannelSession` drives one communication event: the k-th ``mix``
call inside ``comm_update`` is the k-th entry of ``CommSpec.buffers``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch

from ..tree import tree_leaves, tree_map
from .base import NOT_PORTED, ChannelState, Compressor

Tree = Any
SeedFn = Callable[[int, int, int], int]   # (event, buffer, leaf) -> uint32 seed

__all__ = [
    "Transport", "GossipChannel", "SyncChannel", "CHANNELS", "register_channel",
    "make_channel", "link_bytes_per_round", "ChannelSession",
]


class Transport:
    """Engine adapter a channel delivers through.

    ``mix`` is the engine's linear gossip on a raw tree; ``mix_payload``
    delivers an encoded message, which on the dense engine means mixing the
    locally decoded message.  (The sharded engine's payload transports are
    ROADMAP queue 1 item 8.)"""

    def __init__(self, mix_fn: Callable[[Tree], Tree]):
        self._mix_fn = mix_fn

    def mix(self, tree: Tree) -> Tree:
        return self._mix_fn(tree)

    def mix_payload(self, payload: Tree, dec: Tree) -> Tree:
        del payload
        return self.mix(dec)


@dataclasses.dataclass(frozen=True)
class GossipChannel:
    """Base declarative channel spec; ``compression`` is the codec it encodes
    with (a resolved ``Compressor``, or None for raw)."""

    compression: Any = None

    name = "base"

    @property
    def tag(self) -> str:
        comp = self.compression
        return self.name if comp is None else f"{self.name}_{comp.tag}"

    @property
    def is_passthrough(self) -> bool:
        """True when the channel adds nothing over the plain gossip path."""
        return False

    def bind(self, compression: Optional[Compressor]) -> "GossipChannel":
        """Attach the CommSpec's codec; a codec already set here wins."""
        if self.compression is not None or compression is None:
            return self
        return dataclasses.replace(self, compression=compression)

    def message_bytes(self, tree: Tree) -> int:
        """Analytic wire bytes of ONE node's send of this buffer (``tree``
        without the node axis): raw bytes with no active codec, else the
        codec's payload bytes."""
        comp = self.compression
        if comp is None or comp.is_identity:
            return sum(math.prod(l.shape) * l.dtype.itemsize for l in tree_leaves(tree))
        return comp.tree_bytes(tree)

    def init_wire(self, params: Tree) -> Optional[Tree]:
        return None

    def gossip(self, tree: Tree, wire, seed_of_leaf, transport: Transport):
        """One buffer's communication: ``(mixed_tree, new_wire)``."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class SyncChannel(GossipChannel):
    """Synchronous gossip: every node encodes its current value every round;
    the codec's error-feedback residual is the only wire state.  With no
    codec (or identity) it is a pass-through: the executor never builds a
    session for it and gossips through the plain path."""

    name = "sync"

    @property
    def is_passthrough(self) -> bool:
        comp = self.compression
        return comp is None or comp.is_identity

    def init_wire(self, params):
        if self.compression is not None and self.compression.uses_residual:
            return {"res": tree_map(torch.zeros_like, params)}
        return None

    def gossip(self, tree, wire, seed_of_leaf, transport):
        res = wire["res"] if wire is not None else None
        payload, dec, new_res = self.compression.roundtrip(tree, res, seed_of_leaf)
        mixed = transport.mix_payload(payload, dec)
        return mixed, (None if new_res is None else {"res": new_res})


def link_bytes_per_round(spec, params) -> Dict[str, float]:
    """Analytic wire bytes ONE communication round moves, per buffer and
    channel: ``"<buffer>/<channel tag>" -> N * message_bytes``.  ``spec`` is
    the algorithm's ``CommSpec``; ``params`` the node-stacked tree."""
    leaves = tree_leaves(params)
    if not leaves:
        return {}
    n = leaves[0].shape[0]
    per_node = tree_map(
        lambda l: torch.empty(l.shape[1:], dtype=l.dtype, device="meta"), params
    )
    chan = spec.resolved_channel() or SyncChannel()
    return {f"{name}/{chan.tag}": float(chan.message_bytes(per_node)) * n
            for name in spec.buffers}


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------
CHANNELS: Dict[str, Callable[..., GossipChannel]] = {}


def register_channel(name: str, factory: Callable[..., GossipChannel]):
    if name in CHANNELS:
        raise ValueError(f"channel {name!r} already registered")
    CHANNELS[name] = factory
    return factory


def make_channel(spec, **kwargs) -> GossipChannel:
    """Resolve a channel spec: a ready instance or a registry name with an
    optional ``:arg`` shorthand."""
    if isinstance(spec, GossipChannel):
        return spec
    if not isinstance(spec, str):
        raise ValueError(
            f"channel spec must be a name or a GossipChannel, got {type(spec).__name__}"
        )
    name, _, arg = spec.partition(":")
    try:
        factory = CHANNELS[name]
    except KeyError:
        raise ValueError(f"unknown channel {spec!r}; known: {sorted(CHANNELS)}") from None
    return factory(arg, **kwargs) if arg else factory(**kwargs)


def _sync(arg=None, **kw):
    if arg:
        raise ValueError(f"the sync channel takes no :arg shorthand (got {arg!r})")
    return SyncChannel(**kw)


def _unported(name: str):
    def factory(arg=None, **kw):
        raise NotImplementedError(f"the {name} channel {NOT_PORTED}")

    return factory


register_channel("sync", _sync)
register_channel("choco", _unported("choco"))
register_channel("async", _unported("async"))


# --------------------------------------------------------------------------
# one communication event
# --------------------------------------------------------------------------
class ChannelSession:
    """One communication event's channel driver.

    The k-th ``mix`` call inside ``comm_update`` is the k-th declared buffer:
    its wire state is matched positionally, and leaf ``l`` of buffer ``b``
    encodes with seed ``seed_fn(event, b, l)``."""

    def __init__(self, channel: GossipChannel, n_buffers: int,
                 chan_state: ChannelState, transport: Transport, seed_fn: SeedFn):
        self._channel = channel
        self._transport = transport
        self._n_buffers = n_buffers
        self._wire = chan_state.wire
        self._event = chan_state.event
        self._seed_fn = seed_fn
        self._new_wire = []
        self._calls = 0

    def mix(self, tree: Tree) -> Tree:
        i = self._calls
        if i >= self._n_buffers:
            raise ValueError(
                f"comm_update gossiped more than the {self._n_buffers} buffers "
                "declared in CommSpec.buffers; the channel cannot match wire "
                "state to call sites"
            )
        self._calls += 1
        wire = self._wire[i] if i < len(self._wire) else None
        event = self._event
        mixed, new_wire = self._channel.gossip(
            tree, wire, lambda leaf: self._seed_fn(event, i, leaf), self._transport
        )
        self._new_wire.append(new_wire)
        return mixed

    def final_state(self) -> ChannelState:
        if self._calls != self._n_buffers:
            raise ValueError(
                f"comm_update gossiped {self._calls} buffers but CommSpec "
                f"declares {self._n_buffers}; fix the spec's buffers tuple"
            )
        return ChannelState(wire=tuple(self._new_wire), event=self._event + 1)
