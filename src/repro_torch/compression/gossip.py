"""Transport backends for compressed gossip on the sharded engine.

Counterpart of ``repro.compression.gossip``.  The channel layer's
:class:`~repro_torch.compression.channels.Transport` hands a payload combine
``(payload, dec, ctx)``: the encoded message tree (packed payloads, every
tensor node-stacked), the locally decoded message, and the round context.
The Simulator mixes ``dec`` densely.  The sharded engine
(``launch/distributed.py``) moves the packed arrays themselves, so that the
node-link bytes its mesh counts are the payload's:

  * :func:`rotation_combine` -- shift-structured gossip for the sync
    channel: roll the payload, decode per shift, weight-sum;
  * :class:`NeighborExchange` -- the difference channels' (choco, async)
    per-shift replica exchange from the same rolled payloads;
  * :func:`allgather_combine` -- graphs with no shift structure:
    all-gather the payload, decode every message, contract with W.

Rolling a payload rolls every tensor of each ``Packed.data`` together
(top-k's indices and values, QSGD's levels and scales); ``meta`` is
unchanged.  Decoding is rowwise, so decoding a rolled payload is rolling
the decoded one.  Sums run in fp32 in the reference's order: the self
weight first, then the shifts in rotation order, each added in place into
the one accumulator, a leaf at a time.  ``ctx.pattern`` is a host
int, so a schedule selects its rotation where the reference switches with
``lax.switch``.

On a node spread over several ranks -- a model axis (``NodeMesh(model=M)``)
or, under the '2d' layout, D data x M model ranks (``NodeMesh(data=D,
model=M)``, the node's ``mesh.node_group``) -- a payload moves over the
node axis between the ranks of one (data, model) index.  Each rank moves
its own tensors whole: a sharded leaf's tensors of its block (QSGD's
levels of the shard, a low-rank factor's rows of it), its per-node
scalars (QSGD's scale), and a replicated leaf's payload, as the
uncompressed roll moves its shards.  A sharded leaf's ``shared`` tensors
(top-k's and rand-k's indices and values, a low-rank factor whose side
no group splits), which every rank of a node holds whole, move as rank
r's chunk of each node's elements (r = d M + m of the node's D M ranks)
and are joined over the node's ranks after they arrive (``base.
share_split`` / ``share_join``: the model group's gather, then the data
group's).  A tensor a node's D M ranks hold in k distinct blocks (k =
the product of the sizes of the groups that split it; 1 for a replicated
leaf's payload and a per-node scalar) moves D M / k copies of each.  So a
round's node-link bytes, summed over a node's D M ranks, are

    (the model-1 job's, to the byte)
    + sum over the payload's tensors of (D M / k - 1) x its bytes
      (a replicated leaf's payload: D M - 1 copies more; QSGD's 4 B scale
       a sharded leaf, 8 B with the adaptive level count, the same; the
       levels of a leaf split over the model ranks alone: D - 1 more; a
       shared tensor: none)
    + (D M - 1) x (1 B a node for an async send mask)

for every message a node receives (on a model axis D = 1: (M - 1) x the
replicated leaves' payloads and the scales).  On each rank the model
group's ``payload`` bytes are its model peers' chunks and the data
group's its data peers' M chunks each: summed over a node's ranks, (M -
1) and M (D - 1) times the shared tensors' bytes.  (A scenario's round
also gathers each rank's rows of W_t and of the active mask over the
node axis, as at model 1 on more than one rank.)
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from ..core.mixing import Gathered, Rotation, _dense_contract
from ..tree import map_tensors, tree_leaves, tree_map
from .base import Compressor, share_join, share_split

Tree = Any
Combine = Callable[[Tree, Tree, Optional[Any]], Tree]

__all__ = ["rotation_combine", "NeighborExchange", "neighbor_exchange", "allgather_combine",
           "gather_payload"]


def _roll(tree: Tree, shift: int, mesh) -> Tree:
    """Every tensor of ``tree`` (packed payloads, send masks) rolled by
    ``-shift`` along the node axis: ``out[i] = a[(i + shift) mod N]``."""
    if mesh is not None:
        moved, plan = share_split(tree, mesh.node_group)
        return share_join(mesh.roll(moved, shift), plan, mesh.node_group)
    return map_tensors(lambda a: torch.roll(a, -shift, 0), tree)


def gather_payload(tree: Tree, mesh) -> Tree:
    """Every tensor of a payload tree with all N rows (``mesh.all_gather``
    of exactly the payload; shared tensors in chunks, then joined)."""
    moved, plan = share_split(tree, mesh.node_group)
    return share_join(mesh.all_gather(moved), plan, mesh.node_group)


def _pick(rotations, scheduled: bool, ctx):
    if len(rotations) == 1 or not scheduled:
        return rotations[0]
    return rotations[int(ctx.pattern)]


def rotation_combine(comp: Compressor, rotations: Sequence[Rotation],
                     scheduled: bool = False, mesh=None) -> Combine:
    """Compressed shift-structured gossip: ``x_i <- w_self D(m_i) + sum_s
    w_s D(m_{i+s})``, the dense ``sum_j w_ij D(m_j)``, with only payload
    rows crossing between nodes.  ``scheduled=True`` selects the rotation by
    ``ctx.pattern``."""
    rotations = tuple(rotations)
    if not rotations:
        raise ValueError("rotation_combine needs at least one rotation")
    if not scheduled and len(rotations) != 1:
        raise ValueError("static rotation_combine needs exactly one rotation")

    def combine(payload, dec, ctx):
        rot = _pick(rotations, scheduled, ctx)
        acc = tree_map(lambda d: rot.self_weight * d.float(), dec)
        for s, wgt in zip(rot.shifts, rot.weights):
            rolled = _roll(payload, s, mesh)
            # a leaf at a time: each shift's message decoded, weighted and
            # added before the next leaf's is decoded
            for i, (a, p) in enumerate(zip(tree_leaves(acc), tree_leaves(rolled))):
                a.add_(wgt * comp.for_leaf(i).decode(p).float())
            del rolled
        return tree_map(lambda a, d: a.to(d.dtype), acc, dec)

    return combine


class NeighborExchange:
    """Packed neighbour exchange for the difference channels.

    Choco and async channels keep per-shift replica trees ``nbr[k] ==
    roll(x̂, -shifts[k])`` in their wire and advance them from the same
    packed payload every node transmits:

      * ``shifts``   -- the union of the schedule's shifts, in first
                        appearance order (the wire's ``nbr`` layout);
      * ``roll``     -- a (payload) tree rolled by ``-s``: exactly the packed
                        arrays move;
      * ``contract`` -- the rotation-weighted sum of the self replica and the
                        per-shift replicas, in ``Rotation.apply``'s fp32
                        order, so the packed path computes the dense
                        rolled-``x̂`` contraction given the replica
                        invariant.
    """

    def __init__(self, rotations: Sequence[Rotation], scheduled: bool = False, mesh=None):
        self.rotations = tuple(rotations)
        if not self.rotations:
            raise ValueError("neighbor exchange needs at least one rotation")
        self.scheduled = scheduled
        self.mesh = mesh
        self.shifts = tuple(dict.fromkeys(s for rot in self.rotations for s in rot.shifts))

    def roll(self, tree: Tree, shift: int) -> Tree:
        return _roll(tree, shift, self.mesh)

    def contract(self, self_tree: Tree, nbr_trees, ctx) -> Tree:
        by_shift = dict(zip(self.shifts, nbr_trees))
        rot = _pick(self.rotations, self.scheduled, ctx)
        acc = tree_map(lambda x: rot.self_weight * x.float(), self_tree)
        for s, wgt in zip(rot.shifts, rot.weights):
            acc = tree_map(lambda a, r: a.add_(wgt * r.float()), acc, by_shift[s])
        return tree_map(lambda a, x: a.to(x.dtype), acc, self_tree)


def neighbor_exchange(rotations: Sequence[Rotation], scheduled: bool = False,
                      mesh=None) -> NeighborExchange:
    """The engine-side neighbour exchange of a rotation schedule."""
    return NeighborExchange(rotations, scheduled=scheduled, mesh=mesh)


def allgather_combine(comp: Compressor, mesh, w=None, scheduled: bool = False) -> Combine:
    """Compressed allgather for the sync channel on graphs with no shift
    structure: all-gather the packed payload (``mesh.all_gather``: only
    payload bytes move), decode the whole message set on every rank and
    contract with this rank's rows of W (``ctx.w`` when scheduled, else the
    static ``w``)."""
    if not scheduled and w is None:
        raise ValueError("static allgather_combine needs the mixing matrix w")
    w_static = None if w is None else torch.as_tensor(
        np.asarray(w), dtype=torch.float32, device=mesh.device)[mesh.lo:mesh.hi]

    def combine(payload, dec, ctx):
        dec_full = Gathered(comp.decode_tree(gather_payload(payload, mesh)))
        return _dense_contract(ctx.w if scheduled else w_static, dec_full, mesh)

    return combine
