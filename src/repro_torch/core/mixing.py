"""Gossip (mixing) for node-stacked trees: ``x_i <- sum_j w_ij x_j``.

Counterpart of ``repro.core.mixing``.  The backends compute one linear
operator and differ in what crosses between nodes:

  * ``dense_mix``      -- the (N x N) . (N x d) fp32 contraction, a plain
                          ``torch.matmul`` (the reference leaves it to XLA,
                          outside any Pallas kernel);
  * ``allgather_mix``  -- the paper-faithful port: every node gathers all N
                          replicas and contracts with its own row of W;
  * ``roll_mix`` / ``ring_mix`` -- shift-structured topologies: only graph
                          neighbours move, by neighbour send / recv.

plus the scheduled variants of the scenario engine, whose mix signature is
``(tree, ctx)`` with W_t or the rotation pattern from the round's
:class:`~repro_torch.core.algorithm.RoundCtx`.  Static and scheduled
variants share ``_dense_contract`` / :meth:`Rotation.apply`, so a constant
schedule is bit for bit the static mix.

Each backend takes an optional :class:`~repro_torch.launch.mesh.NodeMesh`
(the sharded engine, ``launch/distributed.py``).  Without one, the tree
holds all N nodes (the Simulator).  With one, it holds this rank's rows:
the dense backends all-gather the stack and multiply it by this rank's
rows of W; the roll backends move rows by ``mesh.roll``.

The reference steers its partitioner with four sharding helpers; torch has
no partitioner, so each becomes the act it asks for:

  * ``replicate_gather`` -> ``mesh.all_gather`` (node rows to all N rows);
  * ``replicate_pin``    -> the identity on the data, wrapped as
                            :class:`Gathered`, so that the dense
                            contraction gathers (and counts) nothing for it;
  * ``replicated_local`` -> a direct call, whose node-row inputs are
                            gathered first, as ``shard_map`` with
                            replicated in-specs does;
  * ``node_pin``         -> this rank's rows of a replicated tree.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..tree import tree_map
from .topology import Topology

Tree = Any
MixFn = Callable[[Tree], Tree]

__all__ = [
    "dense_mix", "allgather_mix", "ring_mix", "make_mix_fn", "identity_mix",
    "Rotation", "roll_mix", "scheduled_dense_mix", "scheduled_rotation_mix",
    "replicate_gather", "replicate_pin", "replicated_local", "node_pin", "Gathered",
]


def identity_mix(tree: Tree) -> Tree:
    """No-op mixing (single node / centralized degenerate case)."""
    return tree


@dataclasses.dataclass(frozen=True)
class Gathered:
    """A tree that holds all N node rows on every rank (derived from
    all-gathered payloads): the dense contraction takes it as it is."""

    tree: Tree


def _dense_contract(w: torch.Tensor, tree: Tree, mesh=None) -> Tree:
    """The one dense contraction: leaf (N, ...) -> W @ leaf, fp32 accumulate.

    ``w`` is (rows, N): all of W, or this rank's rows of it on a mesh, where
    the tree is all-gathered first unless it comes as :class:`Gathered`."""
    if isinstance(tree, Gathered):
        tree = tree.tree
    elif mesh is not None:
        tree = mesh.full(tree)

    def one(x):
        out = torch.matmul(w, x.reshape(x.shape[0], -1).float())
        return out.reshape((w.shape[0],) + tuple(x.shape[1:])).to(x.dtype)

    return tree_map(one, tree)


def _rows_of(w: np.ndarray, device, mesh) -> torch.Tensor:
    w = torch.as_tensor(np.asarray(w), dtype=torch.float32,
                        device=mesh.device if mesh is not None else device)
    return w if mesh is None else w[mesh.lo:mesh.hi]


def dense_mix(w: np.ndarray, device=None, mesh=None) -> MixFn:
    """Mixing for node-stacked trees: leaf shape (N, ...) -> (N, ...); on a
    mesh, this rank's rows of W times the gathered stack."""
    return functools.partial(_dense_contract, _rows_of(w, device, mesh), mesh=mesh)


def allgather_mix(w: np.ndarray, mesh) -> MixFn:
    """Paper-faithful dense gossip: all-gather the N replicas, contract with
    this rank's rows of W (the reference's per-device W row inside
    ``shard_map``)."""
    return dense_mix(w, mesh=mesh)


def scheduled_dense_mix(mesh=None) -> Callable[[Tree, Any], Tree]:
    """Dense gossip with the round's mixing matrix taken from ``ctx.w`` (an
    fp32 tensor on the state's device; this rank's rows of W_t on a mesh):
    the same contraction as :func:`dense_mix`, so a constant W_t is bit for
    bit the static mix."""

    def mix(tree: Tree, ctx) -> Tree:
        return _dense_contract(ctx.w, tree, mesh)

    return mix


def _roll(x: torch.Tensor, s: int, mesh) -> torch.Tensor:
    return torch.roll(x, -s, 0) if mesh is None else mesh.roll(x, s)


@dataclasses.dataclass(frozen=True)
class Rotation:
    """One gossip rotation of a shift-structured topology: the self weight
    plus cyclic (shift, weight) pairs, ``x_i <- w_self x_i + sum_s w_s
    x_{(i+s) mod n}``.  :meth:`apply` is the one rotation arithmetic:
    ``roll_mix`` and ``scheduled_rotation_mix`` both call it, so static and
    scheduled rotation gossip are bit for bit the same."""

    self_weight: float
    shifts: tuple[int, ...]
    weights: tuple[float, ...]

    @classmethod
    def from_topology(cls, topology: Topology) -> "Rotation":
        if not topology.shifts:
            raise ValueError(f"{topology.name} is not shift-structured")
        return cls(
            self_weight=topology.self_weight(),
            shifts=topology.shifts,
            weights=topology.shift_weights(),
        )

    def apply(self, tree: Tree, mesh=None) -> Tree:
        """Self weight first, then the shifts in order, in fp32; only the
        neighbours' rows move (``mesh.roll``), in the leaf's own dtype."""

        def one(x):
            acc = self.self_weight * x.float()
            for s, w in zip(self.shifts, self.weights):
                acc.add_(w * _roll(x, s, mesh).float())   # acc + ..., in place
            return acc.to(x.dtype)

        return tree_map(one, tree)


def ring_mix(topology: Topology, mesh=None) -> MixFn:
    """Sparse gossip for shift-structured topologies, as the reference's
    ``ppermute`` backend: node i receives from i - s for every shift s,
    weighted by w[0, s], plus the self weight (for the Metropolis-Hastings
    ring ``x/3 + left/3 + right/3``): the :class:`Rotation` of the
    topology with its shifts negated."""
    if not topology.shifts:
        raise ValueError(
            f"topology {topology.name!r} is not shift-structured; use allgather_mix")
    rot = Rotation.from_topology(topology)
    flipped = Rotation(rot.self_weight, tuple(-s for s in rot.shifts), rot.weights)
    return functools.partial(flipped.apply, mesh=mesh)


def roll_mix(topology: Topology, mesh=None) -> MixFn:
    """Sparse gossip on node-stacked trees: one :class:`Rotation` from the
    topology.  Equal to ``dense_mix`` up to fp32 reassociation for
    shift-structured topologies."""
    if topology.n == 1:
        return identity_mix
    return functools.partial(Rotation.from_topology(topology).apply, mesh=mesh)


def scheduled_rotation_mix(rotations: Sequence[Rotation], mesh=None) -> Callable[[Tree, Any], Tree]:
    """Shift-structured scheduled gossip: ``ctx.pattern`` (a host int)
    selects one of a static tuple of rotations, where the reference
    switches with ``lax.switch``.  A single rotation ignores the pattern,
    so a static schedule is bit for bit :func:`roll_mix`."""
    rotations = tuple(rotations)
    if not rotations:
        raise ValueError("need at least one rotation")

    def mix(tree: Tree, ctx) -> Tree:
        rot = rotations[0] if len(rotations) == 1 else rotations[int(ctx.pattern)]
        return rot.apply(tree, mesh)

    return mix


def replicate_gather(mesh) -> Callable[[Tree], Tree]:
    """The compressed-allgather transport: every node-stacked tensor of a
    (packed payload) tree to all N rows, by ``mesh.all_gather`` of exactly
    those tensors, so only payload bytes move (on a model axis, a sharded
    leaf's shared tensors in chunks: ``compression.gossip.gather_payload``).
    The reference pins the payload behind an optimization barrier so that
    its partitioner cannot hoist the gather into the encode; here nothing
    moves but what is gathered."""
    from ..compression.gossip import gather_payload  # lazy: gossip imports us

    return functools.partial(gather_payload, mesh=mesh)


def replicate_pin(mesh) -> Callable[[Tree], Tree]:
    """The identity on the data: a tree derived from gathered payloads holds
    all N rows and goes to the W contraction as :class:`Gathered`, which
    then moves none of it.  The reference's bare replicated sharding
    constraint keeps its partitioner from re-sharding such a tree and
    paying a dense all-gather at the contraction; on one rank the port's
    count could not otherwise tell it from a tree of node rows."""
    del mesh
    return Gathered


def node_pin(mesh) -> Callable[[Tree], Tree]:
    """This rank's rows of a replicated tree (tensors already of this
    rank's rows pass): applied to the consensus step's replicated terms so
    that the iterate stays node-stacked (the reference's node-sharding
    constraint)."""
    return mesh.rows


def replicated_local(mesh) -> Callable[[Callable], Callable]:
    """Run a replicated-tree -> replicated-tree function directly on every
    rank: its node-row inputs are gathered to all N rows first, as the
    reference's ``shard_map`` with replicated in-specs reshards them, and
    it computes the full result on each rank (the reference guards the
    same locality against its partitioner).  On a model axis "replicated"
    is over the node axis only: the wire holds all N rows of this rank's
    shard of each leaf, and nothing is gathered over the model group."""

    def wrap(fn: Callable) -> Callable:
        if mesh.world == 1:
            return fn   # every row is here: nothing to gather

        def run(*trees: Tree) -> Tree:
            # node rows only: mesh.full with no model dims keeps the shards
            return fn(*(mesh.full(t, model_dims=None) for t in trees))

        return run

    return wrap


def make_mix_fn(topology: Topology, backend: str, mesh=None) -> MixFn:
    """Factory: backend in {'dense', 'roll', 'allgather', 'ring'};
    'allgather' and 'ring' need a mesh (the reference's axis name)."""
    if topology.n == 1:
        return identity_mix
    if backend == "dense":
        return dense_mix(topology.w, mesh=mesh)
    if backend == "roll":
        return roll_mix(topology, mesh)
    if backend == "allgather":
        assert mesh is not None
        return allgather_mix(topology.w, mesh)
    if backend == "ring":
        assert mesh is not None
        return ring_mix(topology, mesh)
    raise ValueError(f"unknown gossip backend {backend!r}")
