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

On a node spread over several ranks (the sharded engine's
``NodeMesh(model=M)``, or ``NodeMesh(data=D, model=M)`` under the '2d'
layout), a leaf sharded along a dim is bound to its :class:`Shard`
(:meth:`Compressor.at_shards`, one binding a leaf): a node's message stays
a function of the whole node, never of a shard.  A shard lies over one
group (the model ranks, or under '2d' the data ranks) along one dim, or
under '2d' over both, the model group along one dim and the data group
along another, in either order of dims.  Every rank of a node arrives at
the same scale, the same index set in the same order and the same send
decision, through collectives over the shard's groups (the model group's
first) that move scalars, candidate lists and low-rank factors, never a
shard; the decoded shard is the shard of what the whole leaf decodes to
(low-rank's fp32 partial sums may reorder).  A leaf replicated over a
group is encoded alike on each of its ranks, with identical bits and no
traffic over that group.  A sharded leaf's :class:`Packed` names its
``shared`` tensors: those that are the whole node's payload, the same on
every rank of the node, which the node axis moves in chunks over the
node's ranks (:func:`share_split` / :func:`share_join`).

This module imports nothing of ``repro_torch.core`` (the executor imports
us, not vice versa).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

Tree = Any
SeedOfLeaf = Callable[[int], int]

__all__ = [
    "Packed", "Compressor", "ErrorFeedback", "ChannelState", "COMPRESSORS",
    "register_compressor", "make_compressor", "attach_channel_state",
    "abstract_channel_state", "compression_error", "Shard", "AtShard", "LeafCodecs",
    "share_split", "share_join", "holds_first",
]


@dataclasses.dataclass
class Packed:
    """Encoded form of ONE node-stacked leaf: ``data`` holds payload tensors
    (each with the leading node axis), ``meta`` what decoding needs.
    ``shared`` names the tensors of a sharded leaf's payload that are the
    whole node's, the same on every model rank (top-k's indices and values,
    a low-rank factor); the rest are this rank's own (QSGD's levels of its
    shard) or, like QSGD's scale, small per-node values every rank moves."""

    data: Dict[str, torch.Tensor]
    meta: Tuple = ()
    shared: Tuple[str, ...] = ()


def _to_global(local: torch.Tensor, whole: Tuple[int, ...], dim: int, lo: int,
               n: int) -> torch.Tensor:
    """Flat indices into the whole per-node shape ``whole`` of the flat
    (int64) indices ``local`` into its shard ``[lo, lo + n)`` along ``dim``
    (row-major both): ``l + (l // (n inner)) (S - n) inner + lo inner``."""
    inner = math.prod(whole[dim + 1:])
    span = whole[dim]
    return local + (local // (n * inner)) * ((span - n) * inner) + lo * inner


def _to_local(flat: torch.Tensor, whole: Tuple[int, ...], dim: int, lo: int,
              n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_to_global`'s inverse: the shard's flat indices of the whole
    shape's and whether each lies in the shard."""
    inner = math.prod(whole[dim + 1:])
    span = whole[dim]
    outer, rest = flat // (span * inner), flat % (span * inner)
    c, i = rest // inner, rest % inner
    inside = (c >= lo) & (c < lo + n)
    return (outer * n + (c - lo)) * inner + i, inside


def holds_first(shard: Optional["Shard"], node) -> bool:
    """Whether this rank counts a leaf's block in a sum over the ranks of a
    node (``node``: its model group, data group or ``NodeGroup``) that
    counts each distinct block once: the rank has index 0 in every group of
    the node that does not split the leaf (``shard`` None: a replicated
    leaf, counted on the node's rank 0)."""
    split = () if shard is None else shard.groups
    return all(g.index == 0 for g in node.groups if not any(g is s for s in split))


@dataclasses.dataclass(frozen=True, eq=False)
class Shard:
    """One leaf's shard on a node spread over ranks: the leaf's whole
    per-node shape ``whole``, split in ``group.size`` equal parts along
    ``dim``, this rank holding part ``group.index``.  Under the '2d' layout
    a leaf split over both the model and the data ranks has ``group`` the
    node's ``launch.mesh.NodeGroup`` and ``data_dim``: split along ``dim``
    over its model group and along ``data_dim`` over its data group, this
    rank holding the block of its two indices; the collectives
    (``group.all_reduce``, ``group.gather``) then run over the node's D x M
    ranks, model group first, and :meth:`owner` numbers them d M + m."""

    group: Any
    dim: int
    whole: Tuple[int, ...]
    data_dim: Optional[int] = None

    @property
    def cuts(self) -> Tuple[Tuple[Any, int], ...]:
        """(group, dim) of each split, the model group's first."""
        if self.data_dim is None:
            return ((self.group, self.dim),)
        return ((self.group.model, self.dim), (self.group.data, self.data_dim))

    @property
    def groups(self) -> Tuple[Any, ...]:
        """The groups that split the leaf."""
        return tuple(g for g, _ in self.cuts)

    @property
    def n(self) -> int:
        """The shard's length along ``dim``."""
        return self.whole[self.dim] // self.cuts[0][0].size

    @property
    def lo(self) -> int:
        return self.cuts[0][0].index * self.n

    @property
    def shape(self) -> Tuple[int, ...]:
        """The shard's per-node shape."""
        shape = list(self.whole)
        for g, d in self.cuts:
            shape[d] //= g.size
        return tuple(shape)

    @property
    def d(self) -> int:
        """Elements of the whole leaf a node."""
        return math.prod(self.whole)

    def to_global(self, local: torch.Tensor) -> torch.Tensor:
        """The whole leaf's flat indices of flat (int64) shard indices."""
        shape = list(self.shape)
        for g, d in self.cuts:
            n = shape[d]
            shape[d] = self.whole[d]
            local = _to_global(local, tuple(shape), d, g.index * n, n)
        return local

    def to_local(self, flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(local, inside)``: the shard's flat indices of the whole leaf's
        flat (int64) indices, and whether each lies in this shard (where it
        does not, ``local`` is meaningless)."""
        shape, inside = list(self.whole), None
        for g, d in reversed(self.cuts):
            n = self.whole[d] // g.size
            flat, ins = _to_local(flat, tuple(shape), d, g.index * n, n)
            shape[d] = n
            inside = ins if inside is None else inside & ins
        return flat, inside

    def owner(self, flat: torch.Tensor) -> torch.Tensor:
        """The index in ``group`` of the rank holding each of the whole
        leaf's flat indices."""
        out = None
        for g, d in reversed(self.cuts):
            inner = math.prod(self.whole[d + 1:])
            o = (flat // inner) % self.whole[d] // (self.whole[d] // g.size)
            out = o if out is None else out * g.size + o
        return out

    def gather(self, t: torch.Tensor, lead: int = 1) -> torch.Tensor:
        """The whole leaf from every rank's shard ``t``, shaped ``lead``
        leading dims + the shard's per-node shape (a collective)."""
        for g, d in self.cuts:
            t = g.all_gather([t], [d + lead])[0]
        return t


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

    def at_shards(self, shards: Sequence[Optional[Shard]], node=None) -> "Compressor":
        """This codec bound to each leaf's shard (None: a replicated leaf,
        encoded whole), leaves in tree order: a :class:`LeafCodecs` of
        :class:`AtShard` bindings; itself where no leaf is sharded.
        ``node`` is the group of the node's ranks that a payload's shared
        tensors are chunked over (None: each shard's group)."""
        if all(s is None for s in shards):
            return self
        return LeafCodecs(tuple(self if s is None else AtShard(inner=self, shard=s, node=node)
                                for s in shards))

    def for_leaf(self, i: int) -> "Compressor":
        """The codec of leaf ``i`` (itself unless bound per leaf)."""
        del i
        return self

    # -- a shard of a leaf (AtShard): the whole leaf's message -------------
    def encode_shard(self, x: torch.Tensor, seed: int, shard: Shard, scale=None) -> Packed:
        """This rank's part of the whole leaf's message, from its shard ``x``
        (a collective over ``shard.group``)."""
        raise NotImplementedError(f"{type(self).__name__} has no sharded encode")

    def decode_shard(self, packed: Packed, shard: Shard) -> torch.Tensor:
        """The shard of the whole leaf's decoded message."""
        raise NotImplementedError(f"{type(self).__name__} has no sharded decode")

    def whole_payload(self, packed: Packed, shard: Shard) -> Packed:
        """The whole leaf's payload from every rank's part (a collective)."""
        raise NotImplementedError(f"{type(self).__name__} has no sharded payload")

    def share_bytes(self, shape: Tuple[int, ...], dtype) -> int:
        """Bytes ONE node's message of a leaf of per-node ``shape`` puts on
        the node axis from this rank: the payload's (a replicated leaf
        moves whole from every model rank)."""
        return self.payload_bytes(shape, dtype)

    def payload_bytes(self, shape: Tuple[int, ...], dtype, scale=None) -> int:
        """Analytic bytes ONE node puts on the wire for a leaf of per-node
        ``shape`` and ``dtype``."""
        raise NotImplementedError

    # -- whole-tree helpers ------------------------------------------------
    def encode_tree(self, tree: Tree, seed_of_leaf: SeedOfLeaf, scale=None) -> Tree:
        leaves, treedef = tree_flatten(tree)
        return tree_unflatten(treedef, [
            self.for_leaf(i).encode(leaf, seed_of_leaf(i), scale=scale)
            for i, leaf in enumerate(leaves)
        ])

    def decode_tree(self, ptree: Tree) -> Tree:
        leaves, treedef = tree_flatten(ptree)
        return tree_unflatten(treedef, [self.for_leaf(i).decode(p) for i, p in enumerate(leaves)])

    def tree_bytes(self, tree: Tree) -> int:
        """Analytic per-node wire bytes for one message of ``tree``'s shape
        (leaves without the node axis); bound to shards, the bytes this
        rank moves (:meth:`share_bytes`)."""
        return sum(self.for_leaf(i).share_bytes(tuple(l.shape), l.dtype)
                   for i, l in enumerate(tree_leaves(tree)))

    def roundtrip(self, tree: Tree, residual: Optional[Tree], seed_of_leaf: SeedOfLeaf,
                  scale=None):
        """(payload, decoded, new_residual) for one gossip message, each
        leaf encoded and decoded before the next one starts."""
        del residual  # residual-free codec
        leaves, treedef = tree_flatten(tree)
        payload, dec = [], []
        for i, leaf in enumerate(leaves):
            codec = self.for_leaf(i)
            payload.append(codec.encode(leaf, seed_of_leaf(i), scale=scale))
            dec.append(codec.decode(payload[-1]))
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

    def at_shards(self, shards, node=None):
        inner = self.inner.at_shards(shards, node)
        return self if inner is self.inner else dataclasses.replace(self, inner=inner)

    def for_leaf(self, i):
        inner = self.inner.for_leaf(i)
        return self if inner is self.inner else dataclasses.replace(self, inner=inner)

    def payload_bytes(self, shape, dtype, scale=None):
        return self.inner.payload_bytes(shape, dtype, scale=scale)

    def share_bytes(self, shape, dtype):
        return self.inner.share_bytes(shape, dtype)

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
            inner = self.inner.for_leaf(i)
            inp = (x.float() + e.float()).to(x.dtype)
            payload.append(inner.encode(inp, seed_of_leaf(i), scale=scale))
            dec.append(inner.decode(payload[-1]))
            new_res.append((inp.float() - dec[-1].float()).to(e.dtype))
            del inp
        return tuple(tree_unflatten(treedef, t) for t in (payload, dec, new_res))


@dataclasses.dataclass(frozen=True)
class AtShard(Compressor):
    """``inner`` bound to one leaf's shard: ``encode`` takes this rank's
    shard and gives this rank's part of the whole leaf's message, ``decode``
    gives the shard of the whole leaf's decoded message
    (``inner.encode_shard`` / ``decode_shard``).  ``payload_bytes`` stays
    the whole leaf's; ``node`` is the group the shared tensors are chunked
    over (None: the shard's)."""

    inner: Compressor = None  # type: ignore[assignment]
    shard: Shard = None       # type: ignore[assignment]
    node: Any = None

    @property
    def is_identity(self):  # type: ignore[override]
        return self.inner.is_identity

    @property
    def tag(self) -> str:
        return self.inner.tag

    def at_rows(self, row0):
        inner = self.inner.at_rows(row0)
        return self if inner is self.inner else dataclasses.replace(self, inner=inner)

    def encode(self, x, seed, scale=None):
        return self.inner.encode_shard(x, seed, self.shard, scale=scale)

    def decode(self, packed):
        return self.inner.decode_shard(packed, self.shard)

    def whole(self, packed: Packed) -> Packed:
        """The whole leaf's payload (a collective over the shard's groups)."""
        return self.inner.whole_payload(packed, self.shard)

    def payload_bytes(self, shape, dtype, scale=None):
        del shape
        return self.inner.payload_bytes(self.shard.whole, dtype, scale=scale)

    def share_bytes(self, shape, dtype):
        """This rank's local tensors and its chunk of the shared ones, from
        the packed structure of a meta tensor (nothing moves)."""
        from ..kernels import api as fused  # lazy: the kernels import the codecs' ops

        with fused.dispatch_mode("ref"):
            packed = self.encode(torch.empty((1,) + tuple(shape), dtype=dtype, device="meta"), 0)
        moved, _ = share_split({"x": packed}, self.node or self.shard.group)
        return sum(t.numel() * t.element_size() for t in moved["x"].data.values())


@dataclasses.dataclass(frozen=True)
class LeafCodecs(Compressor):
    """One codec a leaf, in tree order (:meth:`Compressor.at_shards`):
    every per-leaf call site dispatches through :meth:`for_leaf`."""

    codecs: Tuple[Compressor, ...] = ()

    @property
    def is_identity(self):  # type: ignore[override]
        return self.codecs[0].is_identity

    @property
    def tag(self) -> str:
        return self.codecs[0].tag

    def for_leaf(self, i):
        return self.codecs[i]

    def at_shards(self, shards, node=None):
        """The unbound codec bound to ``shards`` anew."""
        base = next(c.inner if isinstance(c, AtShard) else c for c in self.codecs)
        return base.at_shards(shards, node)

    def at_rows(self, row0):
        bound = tuple(c.at_rows(row0) for c in self.codecs)
        same = all(b is c for b, c in zip(bound, self.codecs))
        return self if same else dataclasses.replace(self, codecs=bound)

    def _per_leaf(self, *_a, **_k):
        raise ValueError("LeafCodecs is bound per leaf: dispatch through for_leaf(i)")

    encode = decode = payload_bytes = _per_leaf


def _chunk(e: int, m: int, size: int) -> Tuple[int, int]:
    """Part m of ``size`` contiguous parts of ``e`` elements."""
    return m * e // size, (m + 1) * e // size


def share_split(tree: Tree, group) -> Tuple[Tree, List[Tuple[int, str, Tuple[int, ...]]]]:
    """What this rank moves over the node axis of a payload tree, ``group``
    the ranks of its node (the model group, or under '2d' the node's D x M
    ranks): each sharded leaf's ``shared`` tensors cut to this rank's chunk
    of each node's elements (part ``group.index`` of ``group.size``
    contiguous parts), every other tensor whole.  Returns the tree and the
    plan :func:`share_join` reads: (leaf, key, per-node shape) of each
    cut."""
    if group is None:
        return tree, []
    leaves, treedef = tree_flatten(tree)
    plan = []
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, Packed) and leaf.shared:
            data = dict(leaf.data)
            for k in leaf.shared:
                t = data[k]
                flat = t.reshape(t.shape[0], -1)
                a, b = _chunk(flat.shape[1], group.index, group.size)
                data[k] = flat[:, a:b]
                plan.append((i, k, tuple(t.shape[1:])))
            leaves[i] = dataclasses.replace(leaf, data=data)
    return tree_unflatten(treedef, leaves), plan


def share_join(tree: Tree, plan, group) -> Tree:
    """The payload tree whole again after its chunks moved: every rank's
    chunks of each cut tensor, gathered over ``group`` in one message to
    each peer of each of its groups (counted as ``payload``) and
    concatenated in rank order."""
    if not plan:
        return tree
    leaves, treedef = tree_flatten(tree)
    parts = [leaves[i].data[k] for i, k, _ in plan]
    shapes = [[(p.shape[0],) + (lambda ab: (ab[1] - ab[0],))(
        _chunk(math.prod(rest), r, group.size)) for p, (_, _, rest) in zip(parts, plan)]
        for r in range(group.size)]
    got = group.gather(parts, key="payload", shapes=shapes)
    for j, (i, k, rest) in enumerate(plan):
        whole = torch.cat([got[r][j] for r in range(group.size)], dim=1)
        leaves[i] = dataclasses.replace(
            leaves[i], data={**leaves[i].data, k: whole.reshape((whole.shape[0],) + rest)})
    return tree_unflatten(treedef, leaves)


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
