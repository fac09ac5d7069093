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
    "compression_error", "NOT_PORTED",
]

#: what the sharded engine's gossip options say when asked for on the port
NOT_PORTED = (
    "belongs to the sharded engine, which is not ported to repro_torch yet "
    "(ROADMAP queue 1 item 8)"
)


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
        """(payload, decoded, new_residual) for one gossip message."""
        del residual  # residual-free codec
        payload = self.encode_tree(tree, seed_of_leaf, scale=scale)
        return payload, self.decode_tree(payload), None


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

    def payload_bytes(self, shape, dtype, scale=None):
        return self.inner.payload_bytes(shape, dtype, scale=scale)

    def roundtrip(self, tree, residual, seed_of_leaf, scale=None):
        if residual is None:
            raise ValueError("ErrorFeedback.roundtrip needs the residual state")
        inp = tree_map(lambda x, e: (x.float() + e.float()).to(x.dtype), tree, residual)
        payload = self.inner.encode_tree(inp, seed_of_leaf, scale=scale)
        dec = self.inner.decode_tree(payload)
        new_res = tree_map(
            lambda i, d, e: (i.float() - d.float()).to(e.dtype), inp, dec, residual
        )
        return payload, dec, new_res


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


def attach_channel_state(algorithm, state):
    """Attach the :class:`ChannelState` the algorithm's spec calls for.

    With no active channel (no codec, or identity) the state is returned
    untouched (``comp=None``), which keeps the plain path structurally the
    uncompressed one."""
    channel = algorithm.comm.resolved_channel()
    if channel is None:
        return state
    wire = tuple(
        channel.for_buffer(i).init_wire(state.params)
        for i in range(len(algorithm.comm.buffers))
    )
    return dataclasses.replace(state, comp=ChannelState(wire=wire))


def compression_error(state) -> torch.Tensor:
    """Sum of ||e||^2 over all error-feedback residuals, as an fp32 0-d
    tensor; NaN when the state carries no residual wire state."""
    comp = getattr(state, "comp", None)
    residuals = [] if comp is None else [
        w["res"] for w in comp.wire if isinstance(w, dict) and w.get("res") is not None
    ]
    if not residuals:
        return torch.tensor(float("nan"))
    return sum(
        torch.sum(leaf.float() ** 2) for tree in residuals for leaf in tree_leaves(tree)
    )
