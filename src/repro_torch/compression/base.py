"""Gossip compression: the ``Compressor`` contract, error feedback, and the
wire state carried in the algorithm state.

Counterpart of ``repro.compression.base``.  A :class:`Compressor` is a frozen
dataclass codec over node-stacked leaves (leading axis N):
``encode(leaf, seed) -> Packed`` / ``decode(Packed) -> leaf``, plus an
analytic ``payload_bytes`` model.  :class:`ErrorFeedback` wraps a lossy codec:
each node transmits ``m = C(x + e)`` and keeps ``e' = x + e - D(m)``.

Randomness is injected: a stochastic codec takes a uint32 ``seed`` per leaf
(a host int), where the reference derives a PRNG key.  ``encode_tree`` takes
``seed_of_leaf(i) -> int`` and asks it for leaf ``i`` in sorted-key leaf
order, the order in which the reference folds ``i`` into its key.

:class:`ChannelState` is the per-node, per-buffer wire state (error-feedback
residuals, replica estimates, staleness ages, in-flight payloads) plus the
number of communication events so far; the seeds of event ``e`` come from
the executor's ``comm_seed_fn``.

This module imports nothing of ``repro_torch.core`` (the executor imports
us, not vice versa).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

Tree = Any
SeedOfLeaf = Callable[[int], int]

__all__ = [
    "Packed", "Compressor", "ErrorFeedback", "ChannelState", "COMPRESSORS",
    "register_compressor", "make_compressor", "attach_channel_state",
    "abstract_channel_state", "compression_error",
]


@dataclasses.dataclass
class Packed:
    """Encoded form of ONE node-stacked leaf: ``data`` holds payload tensors
    (each with the leading node axis), ``meta`` what decoding needs."""

    data: Dict[str, torch.Tensor]
    meta: Tuple = ()


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Base codec; subclasses override encode/decode/payload_bytes."""

    #: True only for the no-op codec: the executor short-circuits it to the
    #: exact uncompressed gossip path (structural bit-parity, no residuals)
    is_identity = False
    #: True when the codec carries per-buffer residual state (ErrorFeedback)
    uses_residual = False

    @property
    def tag(self) -> str:
        return type(self).__name__.lower()

    # -- per-leaf codec ----------------------------------------------------
    def encode(self, x: torch.Tensor, seed: int, scale=None) -> Packed:
        """``scale`` in (0, 1] is the adaptive-compression knob (the share
        of the static payload spent); codecs without one ignore it."""
        raise NotImplementedError

    def decode(self, packed: Packed) -> torch.Tensor:
        raise NotImplementedError

    def at_rows(self, row0: int) -> "Compressor":
        """This codec for leaves whose row 0 is global node ``row0`` (a rank
        of the sharded engine); codecs whose draws do not depend on the node
        are returned as they are."""
        del row0
        return self

    def payload_bytes(self, shape: Tuple[int, ...], dtype, scale=None) -> int:
        """Analytic bytes ONE node puts on the wire for a leaf of per-node
        ``shape`` and ``dtype``."""
        raise NotImplementedError

    # -- whole-tree helpers ------------------------------------------------
    def encode_tree(self, tree: Tree, seed_of_leaf: SeedOfLeaf, scale=None) -> Tree:
        leaves, treedef = tree_flatten(tree)
        return tree_unflatten(treedef, [
            self.encode(leaf, seed_of_leaf(i), scale=scale) for i, leaf in enumerate(leaves)
        ])

    def decode_tree(self, ptree: Tree) -> Tree:
        return tree_map(self.decode, ptree)

    def tree_bytes(self, tree: Tree) -> int:
        """Analytic per-node wire bytes for one message of ``tree``'s shape
        (leaves without the node axis)."""
        return sum(self.payload_bytes(tuple(l.shape), l.dtype) for l in tree_leaves(tree))

    def roundtrip(self, tree: Tree, residual: Optional[Tree], seed_of_leaf: SeedOfLeaf,
                  scale=None):
        """(payload, decoded, new_residual) for one gossip message, each
        leaf encoded and decoded before the next one starts."""
        del residual  # residual-free codec
        leaves, treedef = tree_flatten(tree)
        payload, dec = [], []
        for i, leaf in enumerate(leaves):
            payload.append(self.encode(leaf, seed_of_leaf(i), scale=scale))
            dec.append(self.decode(payload[-1]))
        return tree_unflatten(treedef, payload), tree_unflatten(treedef, dec), None


@dataclasses.dataclass(frozen=True)
class ErrorFeedback(Compressor):
    """Transmit ``m = C(x + e)``, keep ``e' = (x + e) - D(m)`` per node and
    per gossiped buffer.  Decoding is the inner codec's."""

    inner: Compressor = None  # type: ignore[assignment]
    uses_residual = True

    def __post_init__(self):
        if not isinstance(self.inner, Compressor):
            raise ValueError("ErrorFeedback needs an inner Compressor")
        if self.inner.uses_residual:
            raise ValueError("ErrorFeedback cannot wrap another ErrorFeedback")

    @property
    def is_identity(self):  # type: ignore[override]
        return self.inner.is_identity

    @property
    def tag(self) -> str:
        return f"ef_{self.inner.tag}"

    def encode(self, x, seed, scale=None):
        return self.inner.encode(x, seed, scale=scale)

    def decode(self, packed):
        return self.inner.decode(packed)

    def at_rows(self, row0):
        inner = self.inner.at_rows(row0)
        return self if inner is self.inner else dataclasses.replace(self, inner=inner)

    def payload_bytes(self, shape, dtype, scale=None):
        return self.inner.payload_bytes(shape, dtype, scale=scale)

    def roundtrip(self, tree, residual, seed_of_leaf, scale=None):
        """A leaf at a time: its input ``x + e`` is encoded, decoded and
        turned into the new residual, and dropped, before the next leaf's
        is formed (a tree of inputs is never alive)."""
        if residual is None:
            raise ValueError("ErrorFeedback.roundtrip needs the residual state")
        leaves, treedef = tree_flatten(tree)
        res_leaves, res_def = tree_flatten(residual)
        if res_def != treedef:
            raise ValueError(f"residual structure {res_def} differs from the message's {treedef}")
        payload, dec, new_res = [], [], []
        for i, (x, e) in enumerate(zip(leaves, res_leaves)):
            inp = (x.float() + e.float()).to(x.dtype)
            payload.append(self.inner.encode(inp, seed_of_leaf(i), scale=scale))
            dec.append(self.inner.decode(payload[-1]))
            new_res.append((inp.float() - dec[-1].float()).to(e.dtype))
            del inp
        return tuple(tree_unflatten(treedef, t) for t in (payload, dec, new_res))


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------
COMPRESSORS: Dict[str, Callable[..., Compressor]] = {}


def register_compressor(name: str, factory: Callable[..., Compressor]):
    if name in COMPRESSORS:
        raise ValueError(f"compressor {name!r} already registered")
    COMPRESSORS[name] = factory
    return factory


def make_compressor(spec, error_feedback: Optional[bool] = None, **kwargs) -> Compressor:
    """Resolve a compressor spec: a ready instance, or a registry name with
    an optional ``:arg`` shorthand (``"qsgd:63"``).

    ``error_feedback=None`` (default) wraps every lossy codec in
    :class:`ErrorFeedback`; ``False`` gives the raw codec.
    """
    if isinstance(spec, Compressor):
        return spec
    if not isinstance(spec, str):
        raise ValueError(
            f"compression spec must be a name or a Compressor, got {type(spec).__name__}"
        )
    name, _, arg = spec.partition(":")
    try:
        factory = COMPRESSORS[name]
    except KeyError:
        raise ValueError(f"unknown compressor {spec!r}; known: {sorted(COMPRESSORS)}") from None
    comp = factory(arg, **kwargs) if arg else factory(**kwargs)
    if error_feedback is None:
        error_feedback = not comp.is_identity
    return ErrorFeedback(inner=comp) if error_feedback else comp


# --------------------------------------------------------------------------
# wire state (read and written by the round executor's ChannelSession)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class ChannelState:
    """Gossip-channel wire state in the ``comp`` field of a state.

    wire:  one entry per ``CommSpec.buffers`` name, matched positionally to
           the ``mix`` calls inside ``comm_update``, laid out by that
           buffer's channel: ``{"res": tree}`` for sync with error feedback;
           ``{"hat": tree}`` for choco, plus ``"age"`` (int32, (N,)) and
           ``"sent"`` (bool, (N,)) for async, plus ``"fly": {"payload":
           packed tree[, "sent"]}`` with overlap; None for a wire-free
           buffer.
    event: communication events so far (a host int); the codec seeds of
           event ``e`` are ``comm_seed_fn(e, buffer, leaf)``.
    """

    wire: Tuple[Any, ...]
    event: int = 0


def _wire_params(chan, params, n_nodes: Optional[int], like):
    """The params-shaped tree a buffer's wire is laid out over: ``params``
    (node rows), or all ``n_nodes`` rows for a wire held replicated on every
    rank of the sharded engine (``replicated_wire``), built by ``like``."""
    if n_nodes is None or not getattr(chan, "replicated_wire", False):
        return params
    return tree_map(lambda p: like((n_nodes,) + tuple(p.shape[1:]), p), params)


def attach_channel_state(algorithm, state, n_nodes: Optional[int] = None):
    """Attach the :class:`ChannelState` the algorithm's spec calls for.

    With no active channel (no codec, or identity) the state is returned
    untouched (``comp=None``), which keeps the plain path structurally the
    uncompressed one.  ``n_nodes`` is the global node count when the state
    holds one rank's rows of the sharded engine: a replicated wire holds all
    of them."""
    channel = algorithm.comm.resolved_channel()
    if channel is None:
        return state
    wire = []
    for i in range(len(algorithm.comm.buffers)):
        chan = channel.for_buffer(i)
        # a zero-stride view: the wire's zeros_like allocates the rows once
        params = _wire_params(chan, state.params, n_nodes,
                              lambda shape, p: p.new_zeros(()).expand(shape))
        wire.append(chan.init_wire(params))
    return dataclasses.replace(state, comp=ChannelState(wire=tuple(wire)))


def abstract_channel_state(algorithm, state, n_nodes: Optional[int] = None):
    """:func:`attach_channel_state` on the meta device: the same layout with
    meta tensors, allocating nothing (the sharded engine's abstract state).
    ``state`` may hold real or meta tensors."""
    channel = algorithm.comm.resolved_channel()
    if channel is None:
        return state
    wire = tuple(
        channel.for_buffer(i).abstract_wire(_wire_params(
            channel.for_buffer(i), state.params, n_nodes,
            lambda shape, p: torch.empty(shape, dtype=p.dtype, device="meta")))
        for i in range(len(algorithm.comm.buffers))
    )
    return dataclasses.replace(state, comp=ChannelState(wire=wire))


def _wire_entries(state, kind: str):
    """All ``kind`` subtrees ("res", "hat", "age", "sent") across the wire
    state's buffers; empty when no channel state is attached."""
    comp = getattr(state, "comp", None)
    if comp is None:
        return []
    return [w[kind] for w in comp.wire if isinstance(w, dict) and w.get(kind) is not None]


def compression_error(state) -> torch.Tensor:
    """Sum of ||e||^2 over all error-feedback residuals, as an fp32 0-d
    tensor on the state's device; NaN when the state carries no residual
    wire state."""
    residuals = _wire_entries(state, "res")
    if not residuals:
        dev = tree_leaves(state.params)[0].device
        return torch.full((), float("nan"), dtype=torch.float32, device=dev)
    return sum(
        torch.sum(leaf.float() ** 2) for tree in residuals for leaf in tree_leaves(tree)
    )
