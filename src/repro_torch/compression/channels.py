"""Gossip channels: HOW a communication event moves on the wire.

Counterpart of ``repro.compression.channels``.  A communication event
composes three declarative axes:

  * the codec (``Compressor``, ``base.py``): the message representation;
  * the channel (here): the gossip protocol and its per-buffer wire state;
  * the transport (:class:`Transport`): the engine's delivery -- the
    Simulator's dense W contraction of the locally decoded message, or the
    sharded engine's packed transports (``gossip.py``).

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
modes: ``neighbor_shifts`` keeps one replica tree per incoming shift and
rolls only the packed payload; ``replicated_wire`` holds the wire on every
rank with all N rows (the payload is all-gathered when it is stored, and
the replica update and the W contraction run on every rank); ``defer_roll``
rolls an overlapped payload when it is consumed instead of when it is
stored, which gives the same bits.

On a node spread over several ranks (:meth:`GossipChannel.at_shards`: a
model axis, or under '2d' the node's data x model ranks) the codec is bound
to each leaf's shard (``base.AtShard``), the replica algebra runs on the
shards as it is (it is elementwise), and the async trigger's per-node sums
add the shards over the node's ranks, each distinct block once (a leaf
replicated over a group counted from that group's index 0), so that every
rank of a node makes the same send decision.

Under the scenario engine every gossip gets the round's context ``ctx``
(:class:`~repro_torch.core.algorithm.RoundCtx`): the transport mixes with
its W_t, the codecs spend ``ctx.comp_scale`` of their payload, and the async
trigger takes ``ctx.trigger`` in place of its threshold.  Both knobs are host
``np.float32`` scalars, so no codec decision waits on the device; with no
context (the static executor) the channels run at their static settings.

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

from ..kernels import api as fused
from ..tree import map_tensors, tree_flatten, tree_leaves, tree_map, tree_unflatten
from .base import ChannelState, Compressor, ErrorFeedback, Shard, holds_first

Tree = Any
SeedFn = Callable[[int, int, int], int]   # (event, buffer, leaf) -> uint32 seed

__all__ = [
    "Transport", "GossipChannel", "SyncChannel", "ChocoChannel", "AsyncChannel",
    "PerBufferChannel", "CHANNELS", "register_channel", "make_channel",
    "link_bytes_per_round", "ChannelSession",
]


def _n_nodes(tree: Tree) -> int:
    return tree_leaves(tree)[0].shape[0]


def _ctx_scale(ctx):
    return getattr(ctx, "comp_scale", None) if ctx is not None else None


def _tree_sub_f32(a: Tree, b: Tree) -> Tree:
    """a − b in fp32, cast back to a's leaf dtypes."""
    return tree_map(lambda x, y: (x.float() - y.float()).to(x.dtype), a, b)


class Transport:
    """Engine adapter a channel delivers through.

    ``mix``            -- the engine's linear gossip on a raw tree (the
                          Simulator's dense W contraction, the sharded
                          engine's rotations or gathered contraction); with
                          ``scheduled=True`` it takes ``(tree, ctx)``.
    ``mix_payload``    -- payload-level delivery when the engine provides a
                          ``payload_combine`` (``gossip.rotation_combine``,
                          ``allgather_combine``: the packed arrays move);
                          else the locally decoded message goes through
                          ``mix``.
    ``neighbor``       -- packed neighbour exchange for shift-structured
                          gossip (``gossip.neighbor_exchange``).
    ``gather_payload`` -- compressed allgather (``mixing.replicate_gather``):
                          a payload tree to all N rows.
    ``pin_replicated`` -- hands a tree derived from gathered payloads to
                          ``mix`` as all N rows (``mixing.replicate_pin``:
                          ``mixing.Gathered``).
    ``run_local``      -- runs a replicated-tree function on every rank
                          (``mixing.replicated_local``).
    ``pin_node``       -- this rank's rows of a replicated tree
                          (``mixing.node_pin``).

    At most one of ``neighbor`` / ``gather_payload`` is set; without hooks
    every helper is the identity, as on the Simulator."""

    def __init__(self, mix_fn: Callable[..., Tree], scheduled: bool = False, *,
                 payload_combine: Optional[Callable] = None, neighbor=None,
                 gather_payload: Optional[Callable] = None,
                 pin_replicated: Optional[Callable] = None,
                 run_local: Optional[Callable] = None,
                 pin_node: Optional[Callable] = None):
        self._mix_fn = mix_fn
        self._scheduled = scheduled
        self._payload_combine = payload_combine
        self.neighbor = neighbor
        self.gather_payload = gather_payload
        self.pin_replicated = pin_replicated
        self.run_local = run_local
        self.pin_node = pin_node

    def pin(self, tree: Tree) -> Tree:
        return tree if self.pin_replicated is None else self.pin_replicated(tree)

    def node(self, tree: Tree) -> Tree:
        return tree if self.pin_node is None else self.pin_node(tree)

    def local(self, fn: Callable) -> Callable:
        return fn if self.run_local is None else self.run_local(fn)

    def gather(self, tree: Tree) -> Tree:
        """``tree`` as the wire stores it: all N rows under the compressed
        allgather, else as it is (None stays None)."""
        if tree is None or self.gather_payload is None:
            return tree
        return self.gather_payload(tree)

    def mix(self, tree: Tree, ctx=None) -> Tree:
        if self._scheduled:
            return self._mix_fn(tree, ctx)
        return self._mix_fn(tree)

    def mix_payload(self, payload: Tree, dec: Tree, ctx=None) -> Tree:
        if self._payload_combine is not None:
            return self._payload_combine(payload, dec, ctx)
        return self.mix(dec, ctx)


@dataclasses.dataclass(frozen=True)
class GossipChannel:
    """Base declarative channel spec; ``compression`` is the codec it encodes
    with (a resolved ``Compressor``, or None for raw)."""

    compression: Any = None
    #: each leaf's shard (None: replicated), leaves in tree order; () on a
    #: node of one rank
    shards: Tuple[Optional[Shard], ...] = ()
    #: the group of the node's ranks (a model group, a data group or a
    #: ``launch.mesh.NodeGroup``); None on a node of one rank
    node: Any = None

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

    def at_rows(self, row0: int) -> "GossipChannel":
        """This channel with its codec bound to leaves whose row 0 is global
        node ``row0`` (:meth:`Compressor.at_rows`); itself when nothing
        changes."""
        comp = self.compression
        bound = None if comp is None else comp.at_rows(row0)
        return self if bound is comp else dataclasses.replace(self, compression=bound)

    def at_shards(self, shards, node) -> "GossipChannel":
        """This channel on a node spread over several ranks: ``shards`` is
        each leaf's :class:`~.base.Shard` (None: replicated), which binds
        the codec (:meth:`Compressor.at_shards`) and the async trigger's
        sums; ``node`` is the group of the node's ranks."""
        comp = self.compression
        return dataclasses.replace(
            self, shards=tuple(shards), node=node,
            compression=None if comp is None else comp.at_shards(shards, node))

    def node_sum(self, parts) -> torch.Tensor:
        """Σ over a buffer's leaves of per-leaf per-node values ``parts``,
        over the whole node: on a node of several ranks the values summed
        over its ranks (model group first, each in rank order), each
        distinct block once (:func:`~.base.holds_first`), the same bits on
        every rank."""
        if self.node is None:
            return sum(parts)
        total = sum((p for p, s in zip(parts, self.shards) if holds_first(s, self.node)),
                    torch.zeros_like(parts[0]))
        return self.node.all_reduce(total, key="codec")

    def message_bytes(self, tree: Tree) -> int:
        """Analytic wire bytes of ONE node's send of this buffer (``tree``
        without the node axis): raw bytes with no active codec, else the
        codec's payload bytes; on a model axis, those this rank moves
        (``tree`` holds its shards)."""
        comp = self.compression
        if comp is None or comp.is_identity:
            return sum(math.prod(l.shape) * l.dtype.itemsize for l in tree_leaves(tree))
        return comp.tree_bytes(tree)

    def init_wire(self, params: Tree) -> Optional[Tree]:
        return None

    def abstract_wire(self, params: Tree) -> Optional[Tree]:
        """:meth:`init_wire`'s layout as meta tensors (``params`` on any
        device): allocates nothing."""
        meta = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"), params)
        return self.init_wire(meta)

    def wire_spec(self, params: Tree, param_spec: Optional[Tree] = None,
                  node_spec: Any = None) -> Optional[Tree]:
        """Each wire leaf's layout on the sharded engine, in the structure
        of :meth:`abstract_wire`: ``"replicated"`` (all N rows on every
        rank) for a replicated wire; else ``"node"`` (this rank's rows), or
        on a node of several ranks (``param_spec``, the parameters' spec
        tree: their ``"model"`` dims, and under '2d' their ``"data"`` dims)
        the reference's ``wire_spec``: ``param_spec`` for a params-shaped
        tree, ``node_spec`` for a per-node vector and every payload
        tensor."""
        wire = self.abstract_wire(params)
        if wire is None:
            return None
        if getattr(self, "replicated_wire", False):
            return map_tensors(lambda _: "replicated", wire)
        if param_spec is None:
            return map_tensors(lambda _: "node", wire)
        params_like = {"res", "hat", "nbr"}
        return {k: ((param_spec if not isinstance(v, tuple) else tuple(param_spec for _ in v))
                    if k in params_like else map_tensors(lambda _: node_spec, v))
                for k, v in wire.items()}

    def gossip(self, tree: Tree, wire, seed_of_leaf, transport: Transport, ctx=None):
        """One buffer's communication: ``(mixed_tree, new_wire)``; ``ctx`` is
        the scenario engine's round context (None under the static
        executor)."""
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

    def gossip(self, tree, wire, seed_of_leaf, transport, ctx=None):
        comp = self.compression
        if comp is None or comp.is_identity:
            # a raw sync buffer inside a per-buffer mapping: the plain path
            return transport.mix(tree, ctx), None
        res = wire["res"] if wire is not None else None
        payload, dec, new_res = comp.roundtrip(tree, res, seed_of_leaf, scale=_ctx_scale(ctx))
        mixed = transport.mix_payload(payload, dec, ctx)
        return mixed, (None if new_res is None else {"res": new_res})


@dataclasses.dataclass(frozen=True)
class ChocoChannel(GossipChannel):
    """CHOCO difference gossip: per-buffer replica estimates ``x̂``
    (node-stacked, zero at the start) are shared knowledge; each node sends
    ``q(x − x̂)``, every node applies ``x̂⁺ = x̂ + D(q)``, and the iterate
    moves by ``x ← x + γ (W x̂⁺ − x̂⁺)``.  With no codec this still runs the
    replica algebra (it is not a pass-through).

    The sharded engine's wire modes:

      * ``neighbor_shifts`` -- the engine's shift set: the wire grows one
        replica tree per shift (row i of ``nbr[k]`` is node i's replica of
        ``x̂`` at node i + shifts[k]), advanced from the same rolled packed
        payload, so only the encoded difference moves;
      * ``replicated_wire`` -- the whole wire holds all N rows on every
        rank: the payload is all-gathered when it is stored, the replica
        update and the W contraction run on every rank, and the consensus
        step takes this rank's rows of their results;
      * ``defer_roll`` (with ``overlap``) -- the in-flight payload is stored
        unrolled and rolled when consumed, where by default it is stored
        pre-rolled per shift (``fly["rolled"]``): the same bits;
      * ``in_place`` -- the replica trees (``x̂`` and each shift's) advance
        in their own storage, and the consensus step runs in the mix's
        output, where by default the event allocates new trees.  For a
        caller that gives up the state a gossip reads (the sharded engine's
        ``step_fn``): a full-width model's replica trees are GBs a node, and
        the old and the new would otherwise be alive together.  The same
        bits.

    Every path takes the tree through its stages a leaf at a time where it
    can: the difference is encoded, and each message decoded and added to
    its replica, one leaf before the next, so that one leaf's temporaries
    are alive instead of a tree's.

    ``overlap=True`` double-buffers the send: the wire grows ``fly`` with
    the in-flight payload; a round first applies the previous round's
    message, then encodes the next one from the new iterate.  Round 0
    consumes a zero payload, so its consensus step is the identity."""

    gamma: float = 1.0
    neighbor_shifts: Tuple[int, ...] = ()
    replicated_wire: bool = False
    overlap: bool = False
    defer_roll: bool = False
    in_place: bool = False
    name = "choco"

    def __post_init__(self):
        if not 0.0 < float(self.gamma) <= 1.0:
            raise ValueError(f"choco gamma must be in (0, 1], got {self.gamma}")
        if self.neighbor_shifts and self.replicated_wire:
            raise ValueError("neighbor_shifts and replicated_wire are mutually exclusive "
                             "wire modes")
        if self.defer_roll and not self.overlap:
            raise ValueError("defer_roll only applies with overlap=True")

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
    def _payload_struct(self, params):
        """The codec's packed structure over a params-shaped difference, as
        meta tensors: a meta tree encoded through the plain versions, which
        allocates and launches nothing."""
        meta = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"), params)
        if self._raw:
            return meta
        with fused.dispatch_mode("ref"):
            return self.compression.encode_tree(meta, lambda leaf: 0)

    def _sends_mask(self) -> bool:
        """Whether the in-flight message carries a per-node send mask."""
        return False

    def init_wire(self, params):
        dev = tree_leaves(params)[0].device

        def payload():
            return map_tensors(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=dev),
                               self._payload_struct(params))

        def vec():
            return torch.zeros(_n_nodes(params), dtype=torch.bool, device=dev)

        wire = {"hat": tree_map(torch.zeros_like, params)}
        if self.neighbor_shifts:
            wire["nbr"] = tuple(tree_map(torch.zeros_like, params) for _ in self.neighbor_shifts)
        if self.overlap:
            fly = {"payload": payload()}
            if self._sends_mask():
                fly["sent"] = vec()
            if self.neighbor_shifts and not self.defer_roll:
                fly["rolled"] = tuple(payload() for _ in self.neighbor_shifts)
                if self._sends_mask():
                    fly["rolled_sent"] = tuple(vec() for _ in self.neighbor_shifts)
            wire["fly"] = fly
        return wire

    # -- shared protocol pieces --------------------------------------------
    def _encode(self, diff, seed_of_leaf, ctx):
        if self._raw:
            return diff
        return self.compression.encode_tree(diff, seed_of_leaf, scale=_ctx_scale(ctx))

    def _encode_diff(self, tree, hat, seed_of_leaf, ctx):
        """The message ``q(x − x̂)``: each leaf's difference (fp32, in x's
        dtype) encoded and dropped before the next leaf's is formed."""
        if self._raw:
            return _tree_sub_f32(tree, hat)
        xs, treedef = tree_flatten(tree)
        scale = _ctx_scale(ctx)
        return tree_unflatten(treedef, [
            self.compression.for_leaf(i).encode((x.float() - h.float()).to(x.dtype),
                                                seed_of_leaf(i), scale=scale)
            for i, (x, h) in enumerate(zip(xs, tree_leaves(hat)))])

    def _gated_add(self, hat, payload, send):
        """Replica update ``x̂⁺ = x̂ + D(q)`` in fp32 from the message as the
        wire stores it, a leaf at a time (decoded, added, dropped), rows
        gated by the sender's ``send`` mask when the protocol is
        event-triggered; into x̂'s own storage with ``in_place``."""
        hs, treedef = tree_flatten(hat)
        out = []
        for i, (h, p) in enumerate(zip(hs, tree_flatten(payload)[0])):
            d = p if self._raw else self.compression.for_leaf(i).decode(p)
            if send is not None:
                mask = send.reshape((send.shape[0],) + (1,) * (d.dim() - 1))
                d = torch.where(mask, d.float(), 0.0)
            out.append(h.add_(d) if self.in_place else (h.float() + d.float()).to(h.dtype))
            del d
        return tree_unflatten(treedef, out)

    def _consensus_from(self, tree, mixed_hat, hat_new, transport):
        """x + γ (W x̂⁺ − x̂⁺) in fp32, in x's dtype; the replicated wire's
        terms are taken at this rank's rows first.  With ``in_place`` it
        runs in the mix's fp32 output where that is a tensor of its own."""
        g = float(self.gamma)

        def one(x, m, h):
            if self.in_place and m.dtype == torch.float32 and m is not h and m is not x:
                return m.sub_(h).mul_(g).add_(x).to(x.dtype)
            return (x.float() + g * (m.float() - h.float())).to(x.dtype)

        return tree_map(one, tree, transport.node(mixed_hat), transport.node(hat_new))

    def _apply(self, hat, nbr, payload, sent, ctx, transport, rolled=None):
        """Apply one wire message (``payload``/``sent`` as the wire stores
        them): replica update(s) and the W contraction.  ``rolled`` holds
        the pre-rolled ``(payloads, sents)`` per shift, else the payload
        rolls here.  Returns ``(mixed, hat_new, nbr_new)``."""
        if transport.gather_payload is not None:
            # the gathered message set updates the replicated replicas on
            # every rank
            hat_new = transport.local(self._gated_add)(hat, payload, sent)
            return transport.mix(transport.pin(hat_new), ctx), hat_new, None
        hat_new = self._gated_add(hat, payload, sent)
        if nbr is None:
            return transport.mix(hat_new, ctx), hat_new, None
        ex = transport.neighbor
        if ex is None:
            raise ValueError("channel has neighbor-replica wire state but the transport "
                             "provides no neighbor exchange")
        nbr_new = []
        for k, s in enumerate(self.neighbor_shifts):
            if rolled is not None:
                p_s, s_s = rolled[0][k], None if sent is None else rolled[1][k]
            else:
                p_s, s_s = ex.roll(payload, s), None if sent is None else ex.roll(sent, s)
            nbr_new.append(self._gated_add(nbr[k], p_s, s_s))
            del p_s
        nbr_new = tuple(nbr_new)
        return ex.contract(hat_new, nbr_new, ctx), hat_new, nbr_new

    # -- overlap bookkeeping hooks (async overrides) -------------------------
    def _overlap_pre(self, wire):
        """``(sent_in, extra_wire_entries)`` for the in-flight message
        applied this round."""
        return None, {}

    def _overlap_send(self, tree, diff, extra, ctx, transport):
        """The send decision for the next in-flight message (None: always)."""
        return None

    def _gossip_overlap(self, tree, wire, seed_of_leaf, transport, ctx):
        hat, nbr, fly = wire["hat"], wire.get("nbr"), wire["fly"]
        sent_in, extra = self._overlap_pre(wire)
        # 1. apply the message encoded last round (zeros on round 0)
        rolled = None
        if nbr is not None and not self.defer_roll:
            rolled = (fly["rolled"], fly.get("rolled_sent"))
        mixed, hat_new, nbr_new = self._apply(hat, nbr, fly["payload"], sent_in, ctx,
                                              transport, rolled)
        out = self._consensus_from(tree, mixed, hat_new, transport)
        # 2. encode the next in-flight message from the new iterate against
        #    the advanced replica; stored gathered (replicated wire) or rolled
        #    per shift now (neighbour wire without defer_roll)
        diff = _tree_sub_f32(out, transport.node(hat_new))
        send = self._overlap_send(out, diff, extra, ctx, transport)
        payload = transport.gather(self._encode(diff, seed_of_leaf, ctx))
        send = transport.gather(send)
        fly_new = {"payload": payload}
        if send is not None:
            fly_new["sent"] = send
        if nbr is not None and not self.defer_roll:
            ex = transport.neighbor
            fly_new["rolled"] = tuple(ex.roll(payload, s) for s in self.neighbor_shifts)
            if send is not None:
                fly_new["rolled_sent"] = tuple(ex.roll(send, s) for s in self.neighbor_shifts)
        new_wire = {"hat": hat_new, "fly": fly_new}
        if nbr_new is not None:
            new_wire["nbr"] = nbr_new
        new_wire.update(extra)
        return out, new_wire

    def gossip(self, tree, wire, seed_of_leaf, transport, ctx=None):
        if self.overlap:
            return self._gossip_overlap(tree, wire, seed_of_leaf, transport, ctx)
        hat, nbr = wire["hat"], wire.get("nbr")
        payload = self._encode_diff(tree, transport.node(hat), seed_of_leaf, ctx)
        mixed, hat_new, nbr_new = self._apply(hat, nbr, transport.gather(payload), None,
                                              ctx, transport)
        out = self._consensus_from(tree, mixed, hat_new, transport)
        new_wire = {"hat": hat_new}
        if nbr_new is not None:
            new_wire["nbr"] = nbr_new
        return out, new_wire


@dataclasses.dataclass(frozen=True)
class AsyncChannel(ChocoChannel):
    """Stale-mix gossip with CHOCO's replica algebra: a node refreshes its
    public snapshot only when an event fires,

        send_i = (age_i + 1 ≥ max_staleness)  OR  ‖x_i − x̂_i‖² > θ² (‖x_i‖² + 1e-12)

    (sums over all leaves), so between events its neighbours mix against the
    stale snapshot.  A round context's ``trigger`` of 0 or more replaces θ
    for that round; a negative one keeps the static θ.  ``max_staleness=1`` with no codec is the synchronous
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

    def _trigger_send(self, tree, diff, age, ctx):
        """Forced when the age hits the bound, or on relative drift."""
        n = _n_nodes(tree)
        drift2 = self.node_sum([torch.sum(d.float().reshape(n, -1) ** 2, dim=1)
                                for d in tree_leaves(diff)])
        ref2 = self.node_sum([torch.sum(x.float().reshape(n, -1) ** 2, dim=1)
                              for x in tree_leaves(tree)])
        thr = np.float32(self.threshold)
        ctx_thr = getattr(ctx, "trigger", None) if ctx is not None else None
        if ctx_thr is not None and ctx_thr >= 0:
            thr = np.float32(ctx_thr)
        thr2 = float(thr * thr)   # squared in fp32, as the reference does
        forced = (age + 1) >= int(self.max_staleness)
        return forced | (drift2 > thr2 * (ref2 + 1e-12))

    def _overlap_pre(self, wire):
        sent_in = wire["fly"]["sent"]
        age_new = torch.where(sent_in, 0, wire["age"] + 1).to(torch.int32)
        # ``sent`` reports the mask applied this round: the in-flight one
        return sent_in, {"age": age_new, "sent": sent_in}

    def _overlap_send(self, tree, diff, extra, ctx, transport):
        return self._trigger_send(tree, diff, transport.node(extra["age"]), ctx)

    def gossip(self, tree, wire, seed_of_leaf, transport, ctx=None):
        if int(self.max_staleness) == 1 and self._raw:
            # every round is a forced send: the snapshot is the fresh value,
            # so mix it directly, bit for bit the sync channel
            n, dev = _n_nodes(tree), tree_leaves(tree)[0].device
            return transport.mix(tree, ctx), {
                "hat": tree,
                "age": torch.zeros(n, dtype=torch.int32, device=dev),
                "sent": torch.ones(n, dtype=torch.bool, device=dev),
            }
        if self.overlap:
            return self._gossip_overlap(tree, wire, seed_of_leaf, transport, ctx)
        hat, age, nbr = wire["hat"], wire["age"], wire.get("nbr")
        diff = _tree_sub_f32(tree, transport.node(hat))
        send = self._trigger_send(tree, diff, transport.node(age), ctx)
        payload = self._encode(diff, seed_of_leaf, ctx)
        # the replicated wire stores the gathered message and send mask
        payload, send = transport.gather(payload), transport.gather(send)
        mixed, hat_new, nbr_new = self._apply(hat, nbr, payload, send, ctx, transport)
        out = self._consensus_from(tree, mixed, hat_new, transport)
        age_new = torch.where(send, 0, age + 1).to(torch.int32)
        wire_new = {"hat": hat_new, "age": age_new, "sent": send}
        if nbr_new is not None:
            wire_new["nbr"] = nbr_new
        return out, wire_new


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

    def at_rows(self, row0):
        bound = tuple(c.at_rows(row0) for c in self.channels)
        same = all(b is c for b, c in zip(bound, self.channels))
        return self if same else dataclasses.replace(self, channels=bound)

    def at_shards(self, shards, node):
        return dataclasses.replace(self, shards=tuple(shards), node=node,
                                   channels=tuple(c.at_shards(shards, node)
                                                  for c in self.channels))

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

    def abstract_wire(self, params):
        self._no_aggregate()

    def wire_spec(self, params):
        self._no_aggregate()

    def gossip(self, tree, wire, seed_of_leaf, transport, ctx=None):
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

    def mix(self, tree: Tree, ctx=None) -> Tree:
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
            tree, wire, lambda leaf: self._seed_fn(event, i, leaf), self._transport, ctx
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
