"""Gossip channels: HOW a communication event moves on the wire.

Counterpart of ``repro.compression.channels`` for the dense engine.  A
communication event composes three declarative axes:

  * the codec (``Compressor``, ``base.py``): the message representation;
  * the channel (here): the gossip protocol and its per-buffer wire state;
  * the transport (:class:`Transport`): the engine's delivery, here the
    Simulator's dense W contraction of the locally decoded message.

Channels:

  * :class:`SyncChannel`: every node encodes its value every round;
    error-feedback residuals are the only wire state; no codec or identity
    is a pass-through.
  * :class:`ChocoChannel`: CHOCO difference gossip (Koloskova et al. 2019).
    Nodes share replica estimates ``x̂`` and send ``q(x − x̂)``; every node
    applies ``x̂⁺ = x̂ + D(q)`` and moves by ``x ← x + γ (W x̂⁺ − x̂⁺)``.
  * :class:`AsyncChannel`: stale-mix gossip with CHOCO's replica algebra; a
    node refreshes its snapshot only when its age reaches the staleness
    bound or its relative drift passes a threshold.
  * :class:`PerBufferChannel`: one channel per ``CommSpec.buffers`` entry.

``overlap=True`` on choco and async double-buffers the send: each round
applies the message encoded in the previous one.  The sharded engine's wire
modes (``neighbor_shifts``, ``replicated_wire``, ``defer_roll``) and
transport hooks raise ``NotImplementedError`` (ROADMAP queue 1 item 8);
nothing else here does.  The scenario engine's per-round knobs (``comp_scale``,
``trigger``) come with ROADMAP queue 1 item 4, so ``gossip`` takes no
round context yet.

:class:`ChannelSession` drives one communication event: the k-th ``mix``
call inside ``comm_update`` is the k-th entry of ``CommSpec.buffers``, and
goes through ``channel.for_buffer(k)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..tree import tree_leaves, tree_map
from .base import NOT_PORTED, ChannelState, Compressor, ErrorFeedback, Packed

Tree = Any
SeedFn = Callable[[int, int, int], int]   # (event, buffer, leaf) -> uint32 seed

__all__ = [
    "Transport", "GossipChannel", "SyncChannel", "ChocoChannel", "AsyncChannel",
    "PerBufferChannel", "CHANNELS", "register_channel", "make_channel",
    "link_bytes_per_round", "ChannelSession",
]


def _n_nodes(tree: Tree) -> int:
    return tree_leaves(tree)[0].shape[0]


def _tree_sub_f32(a: Tree, b: Tree) -> Tree:
    """a − b in fp32, cast back to a's leaf dtypes."""
    return tree_map(lambda x, y: (x.float() - y.float()).to(x.dtype), a, b)


def _tree_add_f32(a: Tree, b: Tree) -> Tree:
    return tree_map(lambda x, y: (x.float() + y.float()).to(x.dtype), a, b)


class Transport:
    """Engine adapter a channel delivers through.

    ``mix`` is the engine's linear gossip on a raw tree; ``mix_payload``
    delivers an encoded message, which on the dense engine means mixing the
    locally decoded message.  The sharded engine's hooks (``neighbor``,
    ``gather_payload``, ``run_local``) raise ``NotImplementedError`` when
    given."""

    def __init__(self, mix_fn: Callable[[Tree], Tree], *, neighbor=None,
                 gather_payload=None, run_local=None):
        hooks = dict(neighbor=neighbor, gather_payload=gather_payload, run_local=run_local)
        given = sorted(k for k, v in hooks.items() if v is not None)
        if given:
            raise NotImplementedError(f"the transport hooks {given} {NOT_PORTED}")
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

    def for_buffer(self, i: int) -> "GossipChannel":
        """The channel driving the i-th ``CommSpec.buffers`` entry: self for
        uniform channels; :class:`PerBufferChannel` dispatches."""
        return self

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
        comp = self.compression
        if comp is None or comp.is_identity:
            # a raw sync buffer inside a per-buffer mapping: the plain path
            return transport.mix(tree), None
        res = wire["res"] if wire is not None else None
        payload, dec, new_res = comp.roundtrip(tree, res, seed_of_leaf)
        mixed = transport.mix_payload(payload, dec)
        return mixed, (None if new_res is None else {"res": new_res})


@dataclasses.dataclass(frozen=True)
class ChocoChannel(GossipChannel):
    """CHOCO difference gossip: per-buffer replica estimates ``x̂``
    (node-stacked, zero at the start) are shared knowledge; each node sends
    ``q(x − x̂)``, every node applies ``x̂⁺ = x̂ + D(q)``, and the iterate
    moves by ``x ← x + γ (W x̂⁺ − x̂⁺)``.  With no codec this still runs the
    replica algebra (it is not a pass-through).

    ``overlap=True`` double-buffers the send: the wire grows ``fly`` with
    the in-flight payload; a round first applies the previous round's
    message, then encodes the next one from the new iterate.  Round 0
    consumes a zero payload, so its consensus step is the identity.

    ``neighbor_shifts``, ``replicated_wire`` and ``defer_roll`` are the
    sharded engine's wire modes and raise ``NotImplementedError``."""

    gamma: float = 1.0
    neighbor_shifts: Tuple[int, ...] = ()
    replicated_wire: bool = False
    overlap: bool = False
    defer_roll: bool = False
    name = "choco"

    def __post_init__(self):
        if not 0.0 < float(self.gamma) <= 1.0:
            raise ValueError(f"choco gamma must be in (0, 1], got {self.gamma}")
        if self.neighbor_shifts and self.replicated_wire:
            raise ValueError("neighbor_shifts and replicated_wire are mutually exclusive "
                             "wire modes")
        if self.defer_roll and not self.overlap:
            raise ValueError("defer_roll only applies with overlap=True")
        for field in ("neighbor_shifts", "replicated_wire", "defer_roll"):
            if getattr(self, field):
                raise NotImplementedError(f"the {self.name} channel's {field} {NOT_PORTED}")

    def bind(self, compression):
        if self.compression is not None or compression is None:
            return self
        # the replica is the memory: difference gossip drops error feedback
        if isinstance(compression, ErrorFeedback):
            compression = compression.inner
        return dataclasses.replace(self, compression=compression)

    @property
    def _raw(self) -> bool:
        return self.compression is None or self.compression.is_identity

    # -- wire layout --------------------------------------------------------
    def _zero_payload(self, params):
        """The codec's packed structure over a params-shaped difference, all
        zeros: a zero tree is encoded once on the CPU (no kernel launch) and
        every tensor of the result zeroed on the params' device."""
        if self._raw:
            return tree_map(torch.zeros_like, params)
        cpu = tree_map(lambda p: torch.zeros(p.shape, dtype=p.dtype), params)
        packed = self.compression.encode_tree(cpu, lambda leaf: 0)
        dev = tree_leaves(params)[0].device
        return tree_map(
            lambda pk: Packed(
                {k: torch.zeros(t.shape, dtype=t.dtype, device=dev) for k, t in pk.data.items()},
                meta=pk.meta,
            ),
            packed,
        )

    def _sends_mask(self) -> bool:
        """Whether the in-flight message carries a per-node send mask."""
        return False

    def init_wire(self, params):
        wire = {"hat": tree_map(torch.zeros_like, params)}
        if self.overlap:
            fly = {"payload": self._zero_payload(params)}
            if self._sends_mask():
                fly["sent"] = torch.zeros(_n_nodes(params), dtype=torch.bool,
                                          device=tree_leaves(params)[0].device)
            wire["fly"] = fly
        return wire

    # -- shared protocol pieces --------------------------------------------
    def _encode(self, diff, seed_of_leaf):
        if self._raw:
            return diff
        return self.compression.encode_tree(diff, seed_of_leaf)

    def _decode(self, payload):
        if self._raw:
            return payload
        return self.compression.decode_tree(payload)

    def _gated_add(self, hat, dec, send):
        """Replica update ``x̂⁺ = x̂ + D(q)`` in fp32, rows gated by the
        sender's ``send`` mask when the protocol is event-triggered."""
        if send is None:
            return _tree_add_f32(hat, dec)

        def one(h, d):
            mask = send.reshape((send.shape[0],) + (1,) * (d.dim() - 1))
            return (h.float() + torch.where(mask, d.float(), 0.0)).to(h.dtype)

        return tree_map(one, hat, dec)

    def _consensus_from(self, tree, mixed_hat, hat_new):
        """x + γ (W x̂⁺ − x̂⁺) in fp32, in x's dtype."""
        g = float(self.gamma)
        return tree_map(
            lambda x, m, h: (x.float() + g * (m.float() - h.float())).to(x.dtype),
            tree, mixed_hat, hat_new,
        )

    # -- overlap bookkeeping hooks (async overrides) -------------------------
    def _overlap_pre(self, wire):
        """``(sent_in, extra_wire_entries)`` for the in-flight message
        applied this round."""
        return None, {}

    def _overlap_send(self, tree, diff, extra):
        """The send decision for the next in-flight message (None: always)."""
        return None

    def _gossip_overlap(self, tree, wire, seed_of_leaf, transport):
        hat, fly = wire["hat"], wire["fly"]
        sent_in, extra = self._overlap_pre(wire)
        # 1. apply the message encoded last round (zeros on round 0)
        hat_new = self._gated_add(hat, self._decode(fly["payload"]), sent_in)
        out = self._consensus_from(tree, transport.mix(hat_new), hat_new)
        # 2. encode the next in-flight message from the new iterate; it is
        #    decoded when the next round applies it
        diff = _tree_sub_f32(out, hat_new)
        send = self._overlap_send(out, diff, extra)
        fly_new = {"payload": self._encode(diff, seed_of_leaf)}
        if send is not None:
            fly_new["sent"] = send
        return out, {"hat": hat_new, "fly": fly_new, **extra}

    def gossip(self, tree, wire, seed_of_leaf, transport):
        if self.overlap:
            return self._gossip_overlap(tree, wire, seed_of_leaf, transport)
        hat = wire["hat"]
        payload = self._encode(_tree_sub_f32(tree, hat), seed_of_leaf)
        hat_new = self._gated_add(hat, self._decode(payload), None)
        out = self._consensus_from(tree, transport.mix(hat_new), hat_new)
        return out, {"hat": hat_new}


@dataclasses.dataclass(frozen=True)
class AsyncChannel(ChocoChannel):
    """Stale-mix gossip with CHOCO's replica algebra: a node refreshes its
    public snapshot only when an event fires,

        send_i = (age_i + 1 ≥ max_staleness)  OR  ‖x_i − x̂_i‖² > θ² (‖x_i‖² + 1e-12)

    (sums over all leaves), so between events its neighbours mix against the
    stale snapshot.  ``max_staleness=1`` with no codec is the synchronous
    mix, bit for bit.  Wire state per buffer: the snapshot ``hat``, per-node
    ``age`` (int32, rounds since the last send) and ``sent`` (bool, the last
    round's mask)."""

    max_staleness: int = 4
    threshold: float = 0.0
    name = "async"

    def __post_init__(self):
        super().__post_init__()
        if int(self.max_staleness) < 1:
            raise ValueError(f"async max_staleness must be >= 1, got {self.max_staleness}")
        if float(self.threshold) < 0.0:
            raise ValueError(f"async threshold must be >= 0, got {self.threshold}")
        if self.overlap and int(self.max_staleness) < 2:
            raise ValueError(
                "overlap=True double-buffers the send, so the wire message lands one "
                "round late: max_staleness >= 2 required, got "
                f"{self.max_staleness}"
            )

    def _sends_mask(self) -> bool:
        return True

    def init_wire(self, params):
        wire = super().init_wire(params)
        n, dev = _n_nodes(params), tree_leaves(params)[0].device
        wire["age"] = torch.zeros(n, dtype=torch.int32, device=dev)
        wire["sent"] = torch.zeros(n, dtype=torch.bool, device=dev)
        return wire

    @property
    def is_passthrough(self) -> bool:
        # bound 1 forces a send every round: with nothing to compress this
        # is synchronous gossip, so the executor takes the plain path
        return int(self.max_staleness) == 1 and self._raw

    def _trigger_send(self, tree, diff, age):
        """Forced when the age hits the bound, or on relative drift."""
        n = _n_nodes(tree)
        drift2 = sum(torch.sum(d.float().reshape(n, -1) ** 2, dim=1) for d in tree_leaves(diff))
        ref2 = sum(torch.sum(x.float().reshape(n, -1) ** 2, dim=1) for x in tree_leaves(tree))
        thr = np.float32(self.threshold)
        thr2 = float(thr * thr)   # squared in fp32, as the reference does
        forced = (age + 1) >= int(self.max_staleness)
        return forced | (drift2 > thr2 * (ref2 + 1e-12))

    def _overlap_pre(self, wire):
        sent_in = wire["fly"]["sent"]
        age_new = torch.where(sent_in, 0, wire["age"] + 1).to(torch.int32)
        # ``sent`` reports the mask applied this round: the in-flight one
        return sent_in, {"age": age_new, "sent": sent_in}

    def _overlap_send(self, tree, diff, extra):
        return self._trigger_send(tree, diff, extra["age"])

    def gossip(self, tree, wire, seed_of_leaf, transport):
        if int(self.max_staleness) == 1 and self._raw:
            # every round is a forced send: the snapshot is the fresh value,
            # so mix it directly, bit for bit the sync channel
            n, dev = _n_nodes(tree), tree_leaves(tree)[0].device
            return transport.mix(tree), {
                "hat": tree,
                "age": torch.zeros(n, dtype=torch.int32, device=dev),
                "sent": torch.ones(n, dtype=torch.bool, device=dev),
            }
        if self.overlap:
            return self._gossip_overlap(tree, wire, seed_of_leaf, transport)
        hat, age = wire["hat"], wire["age"]
        diff = _tree_sub_f32(tree, hat)
        send = self._trigger_send(tree, diff, age)
        payload = self._encode(diff, seed_of_leaf)
        hat_new = self._gated_add(hat, self._decode(payload), send)
        out = self._consensus_from(tree, transport.mix(hat_new), hat_new)
        age_new = torch.where(send, 0, age + 1).to(torch.int32)
        return out, {"hat": hat_new, "age": age_new, "sent": send}


@dataclasses.dataclass(frozen=True)
class PerBufferChannel(GossipChannel):
    """Per-buffer protocols: the k-th ``CommSpec.buffers`` entry gossips
    through the k-th entry of ``channels`` (built by ``CommSpec`` from a
    ``{buffer_name: spec}`` mapping).  Wire state and session dispatch go
    through :meth:`for_buffer`; the aggregate methods raise, so a call site
    that forgot to dispatch fails loudly."""

    channels: Tuple[GossipChannel, ...] = ()
    name = "per_buffer"

    def __post_init__(self):
        if not self.channels:
            raise ValueError("PerBufferChannel needs at least one sub-channel")
        if any(isinstance(c, PerBufferChannel) for c in self.channels):
            raise ValueError("per-buffer channel mappings cannot nest")

    @property
    def tag(self) -> str:
        return "+".join(c.tag for c in self.channels)

    @property
    def is_passthrough(self) -> bool:
        return all(c.is_passthrough for c in self.channels)

    def bind(self, compression):
        return dataclasses.replace(
            self, channels=tuple(c.bind(compression) for c in self.channels)
        )

    def for_buffer(self, i: int) -> GossipChannel:
        if not 0 <= i < len(self.channels):
            raise ValueError(
                f"buffer index {i} out of range for the {len(self.channels)}-entry "
                "per-buffer channel mapping"
            )
        return self.channels[i]

    def _no_aggregate(self):
        raise ValueError(
            "PerBufferChannel has no aggregate wire layout; dispatch through "
            "for_buffer(i) per CommSpec.buffers entry"
        )

    def init_wire(self, params):
        self._no_aggregate()

    def gossip(self, tree, wire, seed_of_leaf, transport):
        self._no_aggregate()

    def message_bytes(self, tree):
        self._no_aggregate()


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
    chan = spec.resolved_channel()
    out: Dict[str, float] = {}
    for i, name in enumerate(spec.buffers):
        c = chan.for_buffer(i) if chan is not None else SyncChannel()
        out[f"{name}/{c.tag}"] = float(c.message_bytes(per_node)) * n
    return out


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
    """Resolve a channel spec: a ready instance, or a registry name with an
    optional ``:arg`` shorthand (``"choco:0.8"`` = consensus step γ,
    ``"async:2"`` = staleness bound)."""
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


def _choco(arg=None, **kw):
    if arg is not None:
        kw.setdefault("gamma", float(arg))
    return ChocoChannel(**kw)


def _async(arg=None, **kw):
    if arg is not None:
        kw.setdefault("max_staleness", int(arg))
    return AsyncChannel(**kw)


register_channel("sync", _sync)
register_channel("choco", _choco)
register_channel("async", _async)


# --------------------------------------------------------------------------
# one communication event
# --------------------------------------------------------------------------
class ChannelSession:
    """One communication event's channel driver.

    The k-th ``mix`` call inside ``comm_update`` is the k-th declared buffer:
    it goes through ``channel.for_buffer(k)``, its wire state is matched
    positionally, and leaf ``l`` of buffer ``b`` encodes with seed
    ``seed_fn(event, b, l)``."""

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
        mixed, new_wire = self._channel.for_buffer(i).gossip(
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
