"""The node mesh: N decentralized nodes over the ranks of a process group.

Counterpart of ``repro.launch.mesh``.  The reference lays its nodes on a
jax device ``Mesh`` and lets GSPMD lower every cross-node movement to a
collective.  The port has no partitioner, so :class:`NodeMesh` names the
movements itself.  Every node-stacked tensor (leading axis = nodes) holds
this rank's rows ``[lo, hi)``, a contiguous block of ``n_nodes // world``
nodes, and every cross-node movement goes through one of three
primitives:

  * :meth:`NodeMesh.roll` -- ``out[i] = a[(i + s) mod N]`` along the global
    node axis (``jnp.roll(a, -s, axis=0)``): ``torch.roll`` on one rank;
    across ranks ``dist.batch_isend_irecv`` of exactly the rows a rank
    needs from the one or two ranks that hold them;
  * :meth:`NodeMesh.all_gather` -- every rank gets all N rows;
  * :meth:`NodeMesh.all_reduce_sum` -- the global sums of the metrics.

The mesh counts bytes where the data moves, per primitive: node-link bytes
are rows delivered from one node to another (on one rank too), process
bytes those that crossed ranks; each rank counts what it receives.  This
count replaces ``launch/hlo_analysis.py``'s reading of a compiled module.

A mesh with a model axis (``model`` = M > 1) is the reference's data x
model mesh: ``world = D x M`` ranks, rank ``d M + m`` holds model shard m
of node block d (the order of ``repro.launch.mesh.make_test_mesh((D, M))``
's devices).  The three node-axis primitives then run on the gloo subgroup
of the D ranks with model index m, so they move only the shard m holds;
the within-node movements go through :class:`ModelGroup` (the M ranks of
one node block): an all-gather along a dim, a reduce-scatter and an
all-reduce, each summed in rank order so that every rank gets the same
bits, and the tensor-parallel autograd Functions built on them (Megatron's
``copy_to`` and ``reduce_from``; ``sum_shards`` for a statistic summed over
the shards; ``gather_from`` and ``gather_sum``, all-gathers whose
backwards take this rank's part of the gradient or reduce-scatter its
sum).  Its bytes are counted under ``byte_counts()["model"]``.
``model=1`` makes no subgroup and calls no collective of its own.

A mesh with a within-node data axis (``data`` = D given) is the
reference's pod x data x model mesh, ``make_test_mesh((P, D, M), ("pod",
"data", "model"))``: ``world = P x D x M`` ranks, rank ``p D M + d M + m``,
the layout of the '2d' sharding profile, whose nodes run across ``pod``
only.  The node-axis primitives then run on the P ranks that share ``(d,
m)``; the model group is the M ranks that share ``(p, d)``; and a
:class:`DataGroup`, the D ranks that share ``(p, m)``, splits a node's
batch and its data-sharded parameter dims, with the same all-gather,
reduce-scatter and all-reduce (each summed in rank order) and ``sum_below``
(the counts of the data ranks before this one), its bytes counted under
``byte_counts()["data"]``.  ``axis_names`` then reads ``("pod", "data",
"model")``, so that a profile's ``node_axes`` decides the node count as
the reference's does; a mesh made without ``data`` keeps its ``("data",
"model")`` axes and its subgroups as they were.  ``node_group`` is the D x
M ranks of one node as one group (:class:`NodeGroup`, index ``d M + m``):
its all-reduce and gather run the model group's collective, then the data
group's, so that every rank of a node gets the same bits without a third
subgroup; each part counts its bytes under its own group's key.  A node
over one group has that group as its ``node_group``, and a node on one
rank none.

The backend is gloo.  Gloo moves no CUDA tensor on send, recv or
all-gather, so on the card the mesh stages exactly the payload rows through
host buffers: one device-to-host copy of the rows a peer needs, the gloo
transfer, one host-to-device copy of what arrived.  NCCL will not put two
ranks on one device, and a NCCL mesh over more than one card is ROADMAP
queue 1 item 8 (b); asking for another backend raises.  The reference's
TPU v5e constants (``PEAK_FLOPS``, ``HBM_BW``, ``ICI_BW``) are not carried
over.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..tree import map_tensors

__all__ = ["NodeMesh", "ModelGroup", "DataGroup", "NodeGroup", "make_test_mesh",
           "make_group_mesh", "OPS", "MODEL_OPS", "DATA_OPS"]

#: the three primitives, the keys of :meth:`NodeMesh.byte_counts`
OPS = ("roll", "all_gather", "all_reduce")
#: the model group's movements, the keys of ``byte_counts()["model"]``: the
#: layouts' (``all_gather``, ``reduce_scatter``, ``all_reduce``), the codecs'
#: and channels' statistics, candidates and factors (``codec``), and the
#: payload chunks a node's ranks join after they arrive (``payload``)
MODEL_OPS = ("all_gather", "reduce_scatter", "all_reduce", "codec", "payload")
#: the data group's movements, the keys of ``byte_counts()["data"]``: the
#: '2d' layout's gathers of data-sharded parameters and reductions of their
#: gradients, the loss's and the MoE's sums, the MoE's queue offsets, and
#: the codecs' and payloads' movements as on the model group
DATA_OPS = ("all_gather", "reduce_scatter", "all_reduce", "sum_below", "codec", "payload")


def _tensors(obj: Any) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    map_tensors(out.append, obj)
    return out


def _refill(obj: Any, new: List[torch.Tensor]) -> Any:
    it = iter(new)
    return map_tensors(lambda _: next(it), obj)


def _row_bytes(x: torch.Tensor) -> int:
    return (x[0].numel() if x.dim() else 1) * x.element_size()


def _padded(nbytes: int) -> int:
    """Bytes a part takes in a staging buffer: padded to 8, so that every
    part starts where any dtype may view it."""
    return (nbytes + 7) // 8 * 8


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    """A tensor's elements as a flat uint8 tensor on its device, zero-padded
    to :func:`_padded` bytes."""
    b = x.contiguous().reshape(-1).view(torch.uint8)
    pad = _padded(b.numel()) - b.numel()
    return torch.cat([b, b.new_zeros(pad)]) if pad else b


def _from_bytes(buf: torch.Tensor, at: int, dtype, shape) -> Tuple[torch.Tensor, int]:
    """The tensor of ``shape`` stored at byte ``at`` of a staging buffer,
    and the byte where the next part starts."""
    size = torch.Size(shape).numel() * torch.empty((), dtype=dtype).element_size()
    return buf[at:at + size].view(dtype).reshape(shape), at + _padded(size)


def _split(x: torch.Tensor, dim: int, parts: int, i: int) -> torch.Tensor:
    """Part ``i`` of ``parts`` equal parts of ``x`` along ``dim``."""
    n = x.shape[dim] // parts
    return x.narrow(dim, i * n, n)


class ModelGroup:
    """The M ranks of one node block along the model axis.

    ``index`` is this rank's model index m, ``size`` is M.  Every movement
    sends one message to each peer (gloo send / recv), staged through host
    buffers (gloo moves no CUDA tensor; on the card the buffers are pinned
    and kept for the next call of the same size), and sums in rank order,
    so that a sum is the same bits on every rank and does not depend on
    which rank computes it.  The tensor-parallel model code calls
    :meth:`copy_to` (identity forward, all-reduce backward) on the input of
    a parallel region and :meth:`reduce_from` (all-reduce forward, identity
    backward) on its partial output; :meth:`sum_shards` (all-reduce both
    ways) on a sum over the shards that feeds each rank's own shard (a
    norm's statistic); :meth:`gather_from` (all-gather forward, the rank's
    part of the gradient backward) on shards every rank then uses whole
    (the MoE router's logits); :meth:`gather_sum` (all-gather forward,
    reduce-scatter backward) on shards of which each rank uses its own part
    (Mamba-2's fused projection).
    """

    #: the movements :meth:`byte_counts` reports
    ops = MODEL_OPS

    def __init__(self, group, size: int, index: int, device):
        self.group = group
        self.size = int(size)
        self.index = int(index)
        self.device = device
        self._host: Dict[Tuple[str, int, int], torch.Tensor] = {}
        self.reset_bytes()

    def __repr__(self) -> str:
        return f"{type(self).__name__}(size={self.size}, index={self.index})"

    @property
    def groups(self) -> Tuple["ModelGroup", ...]:
        """The groups this one composes: itself (:class:`NodeGroup`: two)."""
        return (self,)

    def reset_bytes(self) -> None:
        self._bytes = {op: 0 for op in self.ops}

    def byte_counts(self) -> Dict[str, int]:
        """Bytes this rank received over the model group, by movement."""
        return dict(self._bytes)

    def _staging(self, slot: str, peer: int, nbytes: int) -> torch.Tensor:
        """A host buffer of ``nbytes`` for one peer's message: pinned and
        kept on the card, a fresh one on the CPU."""
        if self.device.type != "cuda":
            return torch.empty(nbytes, dtype=torch.uint8)
        key = (slot, peer, nbytes)
        if key not in self._host:
            self._host[key] = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return self._host[key]

    def _exchange(self, msgs: Dict[int, torch.Tensor],
                  sizes: Optional[Dict[int, int]] = None) -> Dict[int, torch.Tensor]:
        """Send ``msgs[r]`` (uint8, on the device) to each peer r; return
        what each peer sent, on the device.  ``sizes[r]`` is the byte size
        of peer r's message (default: the size of the one sent to it)."""
        ops, recv = [], {}
        for r, msg in msgs.items():
            peer = dist.get_global_rank(self.group, r)
            out = self._staging("send", r, msg.numel())
            out.copy_(msg)
            recv[r] = self._staging("recv", r, msg.numel() if sizes is None else sizes[r])
            ops += [dist.P2POp(dist.isend, out, peer, self.group),
                    dist.P2POp(dist.irecv, recv[r], peer, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return {r: b.to(self.device) for r, b in recv.items()}

    def _peers(self) -> List[int]:
        return [r for r in range(self.size) if r != self.index]

    def all_gather(self, leaves: Sequence[torch.Tensor], dims: Sequence[Optional[int]]
                   ) -> List[torch.Tensor]:
        """Each leaf's shards concatenated along its dim, in one message to
        each peer; a leaf with dim None is replicated and passes as it is."""
        idx = [i for i, d in enumerate(dims) if d is not None]
        out = list(leaves)
        if not idx:
            return out
        parts = [leaves[i].detach() for i in idx]
        mine = torch.cat([_as_bytes(x) for x in parts])
        arrived = self._exchange({r: mine for r in self._peers()})
        del mine
        self._bytes["all_gather"] += (self.size - 1) * sum(
            x.numel() * x.element_size() for x in parts)
        at = 0
        for i, x in zip(idx, parts):
            shards = [x if r == self.index else
                      _from_bytes(arrived[r], at, x.dtype, tuple(x.shape))[0]
                      for r in range(self.size)]
            out[i] = torch.cat(shards, dim=dims[i])
            at += _padded(x.numel() * x.element_size())
        return out

    def reduce_scatter(self, leaves: Sequence[torch.Tensor], dims: Sequence[Optional[int]]
                       ) -> List[torch.Tensor]:
        """The sum over the ranks of each leaf, this rank's part of it along
        its dim (the whole sum for dim None), all leaves in one message to
        each peer; the parts are summed in rank order."""
        def part(x, d, r):
            return x.detach() if d is None else _split(x.detach(), d, self.size, r)

        arrived = self._exchange({
            r: torch.cat([_as_bytes(part(x, d, r)) for x, d in zip(leaves, dims)])
            for r in self._peers()})
        self._bytes["reduce_scatter"] += (self.size - 1) * sum(
            part(x, d, self.index).numel() * x.element_size() for x, d in zip(leaves, dims))
        out, at = [], 0
        for x, d in zip(leaves, dims):
            mine = part(x, d, self.index)
            shape, size = tuple(mine.shape), mine.numel() * mine.element_size()
            acc = None
            for r in range(self.size):
                p = mine if r == self.index else _from_bytes(arrived[r], at, x.dtype, shape)[0]
                acc = p.clone() if acc is None else acc.add_(p)
            out.append(acc)
            at += _padded(size)
        return out

    def gather(self, parts: Sequence[torch.Tensor], key: str = "codec",
               shapes: Optional[Sequence[Sequence[Tuple[int, ...]]]] = None
               ) -> List[List[torch.Tensor]]:
        """Every rank's ``parts``, in rank order (this rank's own as they
        are), in one message to each peer, counted under ``key``.
        ``shapes[r][j]`` is the shape of rank r's part j (default: the shape
        of this rank's); the dtypes are this rank's.  Callers sum or
        concatenate the parts in rank order, so that every rank gets the
        same bits.  Meta tensors move nothing: each rank's parts are meta
        tensors of their shapes."""
        parts = [p.detach() for p in parts]

        def shape_of(r, j):
            return tuple(parts[j].shape) if shapes is None else tuple(shapes[r][j])

        if any(p.is_meta for p in parts):
            return [[torch.empty(shape_of(r, j), dtype=p.dtype, device="meta")
                     for j, p in enumerate(parts)] for r in range(self.size)]

        def nbytes(r):
            return sum(_padded(math.prod(shape_of(r, j)) * p.element_size())
                       for j, p in enumerate(parts))

        # 8 trailing bytes: no message is empty, whatever the parts' sizes
        mine = torch.cat([_as_bytes(p) for p in parts]
                         + [torch.zeros(8, dtype=torch.uint8, device=self.device)])
        arrived = self._exchange({r: mine for r in self._peers()},
                                 {r: nbytes(r) + 8 for r in self._peers()})
        del mine
        out = []
        for r in range(self.size):
            if r == self.index:
                out.append(list(parts))
                continue
            at, got = 0, []
            for j, p in enumerate(parts):
                t, at = _from_bytes(arrived[r], at, p.dtype, shape_of(r, j))
                got.append(t)
                self._bytes[key] += t.numel() * t.element_size()
            out.append(got)
        return out

    def all_reduce(self, x: torch.Tensor, op: str = "sum", key: str = "all_reduce"
                   ) -> torch.Tensor:
        """The sum (in rank order) or the max of ``x`` over the ranks,
        counted under ``key``; a meta tensor passes as it is."""
        if x.is_meta:
            return x
        self._bytes[key] += (self.size - 1) * x.numel() * x.element_size()
        if op == "max":
            host = x.detach().cpu().clone()
            dist.all_reduce(host, op=dist.ReduceOp.MAX, group=self.group)
            return host.to(x.device)
        if op != "sum":
            raise ValueError(op)
        mine = x.detach()
        arrived = self._exchange({r: _as_bytes(mine) for r in self._peers()})
        acc = None
        for r in range(self.size):
            p = mine if r == self.index else _from_bytes(arrived[r], 0, x.dtype,
                                                          tuple(x.shape))[0]
            acc = p.clone() if acc is None else acc.add_(p)
        return acc

    def copy_to(self, x: torch.Tensor) -> torch.Tensor:
        """Identity forward, gradient all-reduced (fp32) backward."""
        return _CopyToModel.apply(x, self)

    def reduce_from(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce (fp32, cast back to x's dtype) forward, identity
        backward: for a partial output that every rank then uses whole."""
        return _ReduceFromModel.apply(x, self)

    def sum_shards(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce (fp32, cast back) forward and backward: for a sum
        over the shards (a norm's statistic) that feeds each rank's own
        shard, so that every rank's part of the gradient reaches every
        shard."""
        return _SumShards.apply(x, self)

    def gather_from(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """All-gather along ``dim`` forward, this rank's part of the
        gradient backward: for shards that every rank then uses whole."""
        return _GatherFromModel.apply(x, self, dim)

    def gather_sum(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """All-gather along ``dim`` forward, the gradient's sum over the
        ranks reduce-scattered (fp32, cast back) backward: for shards of
        which each rank uses a part of its own."""
        return _GatherSum.apply(x, self, dim)


class DataGroup(ModelGroup):
    """The D ranks of one node along its within-node data axis (the '2d'
    profile): the same movements as :class:`ModelGroup`, counted under
    :data:`DATA_OPS`, and :meth:`sum_below`.  ``world`` / ``rank`` are its
    size and this rank's index, the names a MoE reads off the mesh that
    splits its batch (``models/mlp.py``)."""

    ops = DATA_OPS

    @property
    def world(self) -> int:
        return self.size

    @property
    def rank(self) -> int:
        return self.index

    def sum_below(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the data ranks below this one (zeros on
        data rank 0), added in rank order: where a node's batch lies over the
        data ranks in rank order, the counts of what comes before this
        rank's rows (a MoE's queue positions)."""
        parts = self.gather([x], key="sum_below")
        out = torch.zeros_like(x)
        for r in range(self.index):
            out += parts[r][0]
        return out


class NodeGroup:
    """The D x M ranks of one node under the '2d' layout, as one group of
    ``size`` D M, this rank at ``index`` d M + m: each collective runs over
    the model group, then over the data group, so that every rank of the
    node gets the same bits.  The parts count their bytes under their own
    group's key (``byte_counts()["model"]`` and ``["data"]``)."""

    def __init__(self, model: ModelGroup, data: DataGroup):
        self.model, self.data = model, data
        self.size = model.size * data.size
        self.index = data.index * model.size + model.index

    def __repr__(self) -> str:
        return f"NodeGroup(model={self.model!r}, data={self.data!r})"

    @property
    def groups(self) -> Tuple[ModelGroup, ModelGroup]:
        return (self.model, self.data)

    def all_reduce(self, x: torch.Tensor, op: str = "sum", key: str = "all_reduce"
                   ) -> torch.Tensor:
        """The sum (over the model ranks in rank order, then over the data
        ranks) or the max of ``x`` over the node's ranks."""
        return self.data.all_reduce(self.model.all_reduce(x, op, key), op, key)

    def gather(self, parts: Sequence[torch.Tensor], key: str = "codec",
               shapes: Optional[Sequence[Sequence[Tuple[int, ...]]]] = None
               ) -> List[List[torch.Tensor]]:
        """Every rank's ``parts`` in the node's rank order (``shapes[r][j]``
        as :meth:`ModelGroup.gather` reads it, ``r`` = d M + m): gathered over
        the model group, then each data rank's M lists over the data group."""
        m_size, d_size, n = self.model.size, self.data.size, len(parts)

        def at(d, m):
            return list(shapes[d * m_size + m])

        by_m = self.model.gather(parts, key, None if shapes is None else
                                 [at(self.data.index, m) for m in range(m_size)])
        by_d = self.data.gather([t for row in by_m for t in row], key,
                                None if shapes is None else
                                [[s for m in range(m_size) for s in at(d, m)]
                                 for d in range(d_size)])
        return [by_d[d][m * n:(m + 1) * n] for d in range(d_size) for m in range(m_size)]


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.float()).to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce(x.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.float()).to(g.dtype), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather([x], [dim])[0]

    @staticmethod
    def backward(ctx, g):
        return _split(g, ctx.dim, ctx.group.size, ctx.group.index).contiguous(), None, None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather([x], [dim])[0]

    @staticmethod
    def backward(ctx, g):
        return ctx.group.reduce_scatter([g.float()], [ctx.dim])[0].to(g.dtype), None, None


class NodeMesh:
    """``n_nodes`` nodes over the ranks of ``group`` (None: world 1, every
    node on this process's device).

    ``lo`` / ``hi`` bound this rank's node rows; ``n_local = hi - lo``.
    Tensors are node-stacked on ``device``; host staging is explicit (see
    the module docstring)."""

    def __init__(self, n_nodes: int, group=None, device=None, model: int = 1,
                 data: Optional[int] = None):
        self.n_nodes = int(n_nodes)
        self.model = int(model)
        # the within-node data axis: None (no such axis, the (data, model)
        # mesh) or its size D
        self.data_axis = data is not None
        self.data = 1 if data is None else int(data)
        self.device = resolve_device(device)
        self.model_group: Optional[ModelGroup] = None
        self.data_group: Optional[DataGroup] = None
        # the ranks of one node: the model group, the data group, both
        # (NodeGroup) or none
        self.node_group: Any = None
        if group is None:
            if self.model != 1 or self.data != 1:
                raise ValueError(f"a model axis of {self.model} and a data axis of "
                                 f"{self.data} need a process group")
            self.world, self.rank = 1, 0
        else:
            backend = dist.get_backend(group)
            if backend != "gloo":
                raise NotImplementedError(
                    f"a node mesh over the {backend!r} backend (more than one card, "
                    "NCCL) is ROADMAP queue 1 item 8 (b); the port's mesh runs on gloo")
            self.world = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
            block = self.model * self.data
            if self.model < 1 or self.data < 1 or self.world % block:
                raise ValueError(f"a data axis of {self.data} x a model axis of {self.model} "
                                 f"does not split {self.world} ranks")
            if block > 1:
                group = self._split_axes(group)
        self.group = group
        if self.n_nodes < 1 or self.n_nodes % self.world:
            raise ValueError(f"{self.n_nodes} nodes do not split over {self.world} ranks")
        self.n_local = self.n_nodes // self.world
        self.lo = self.rank * self.n_local
        self.hi = self.lo + self.n_local
        self.reset_bytes()

    def _split_axes(self, group):
        """The mesh's subgroups of ``group`` (every rank of it makes all of
        them, in one order): the node axis over the P ranks that share ``(d,
        m)``, returned, with ``world`` / ``rank`` its size and this rank's
        index p; on a model axis the model group over the M ranks that share
        ``(p, d)``; on a data axis the data group over the D ranks that
        share ``(p, m)`` (D = 1: the (data, model) mesh, P its data size)."""
        ranks = dist.get_process_group_ranks(group)
        m_size, d_size = self.model, self.data
        p_size = self.world // (m_size * d_size)
        p, rest = divmod(self.rank, d_size * m_size)
        d, m = divmod(rest, m_size)

        def at(q, i, j):
            return ranks[(q * d_size + i) * m_size + j]

        node_groups = {(i, j): dist.new_group([at(q, i, j) for q in range(p_size)],
                                              backend="gloo")
                       for i in range(d_size) for j in range(m_size)}
        if m_size > 1:
            model_groups = {(q, i): dist.new_group([at(q, i, j) for j in range(m_size)],
                                                   backend="gloo")
                            for q in range(p_size) for i in range(d_size)}
            self.model_group = ModelGroup(model_groups[p, d], m_size, m, self.device)
        if d_size > 1:
            data_groups = {(q, j): dist.new_group([at(q, i, j) for i in range(d_size)],
                                                  backend="gloo")
                           for q in range(p_size) for j in range(m_size)}
            self.data_group = DataGroup(data_groups[p, m], d_size, d, self.device)
        self.node_group = (NodeGroup(self.model_group, self.data_group)
                           if self.model_group is not None and self.data_group is not None
                           else self.model_group or self.data_group)
        self.world, self.rank = p_size, p
        return node_groups[d, m]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        """The mesh axes the sharding profiles read: ``("data", "model")``,
        or ``("pod", "data", "model")`` with a within-node data axis."""
        return ("pod", "data", "model") if self.data_axis else ("data", "model")

    @property
    def devices(self) -> np.ndarray:
        """The ranks as a (data, model) or (pod, data, model) array (the
        reference's ``mesh.devices``; its shape gives the axis sizes)."""
        shape = ((self.world, self.data, self.model) if self.data_axis
                 else (self.world, self.model))
        return np.arange(math.prod(shape)).reshape(shape)

    def __repr__(self) -> str:
        data = f", data={self.data}" if self.data_axis else ""
        return (f"NodeMesh(n_nodes={self.n_nodes}, world={self.world}, rank={self.rank}, "
                f"model={self.model}{data}, rows=[{self.lo}, {self.hi}), "
                f"device={self.device})")

    # ---------------------------------------------------------- accounting
    def reset_bytes(self) -> None:
        self._bytes = {op: {"node_link": 0, "process": 0} for op in OPS}
        for g in (self.model_group, self.data_group):
            if g is not None:
                g.reset_bytes()

    def byte_counts(self) -> Dict[str, Dict[str, int]]:
        """``{primitive: {"node_link": B, "process": B}}`` received by this
        rank's nodes since the last :meth:`reset_bytes`; on a model axis
        also ``"model"``: ``{movement: B}`` this rank received over its
        :class:`ModelGroup`, and on a data axis ``"data"``, over its
        :class:`DataGroup`."""
        out = {op: dict(c) for op, c in self._bytes.items()}
        if self.model_group is not None:
            out["model"] = self.model_group.byte_counts()
        if self.data_group is not None:
            out["data"] = self.data_group.byte_counts()
        return out

    def _count(self, op: str, node_link: int, process: int) -> None:
        self._bytes[op]["node_link"] += int(node_link)
        self._bytes[op]["process"] += int(process)

    def _check_local(self, leaves: List[torch.Tensor], what: str) -> None:
        for x in leaves:
            if x.dim() == 0 or x.shape[0] != self.n_local:
                raise ValueError(
                    f"{what} needs node-stacked tensors with this rank's {self.n_local} "
                    f"rows, got shape {tuple(x.shape)}")

    # ---------------------------------------------------------- primitives
    def _runs(self, dst: int, s: int) -> List[Tuple[int, int, int, int]]:
        """The rows rank ``dst`` needs for a roll by ``s``: ``(src rank,
        src row, rows, dst row)`` runs in destination order (at most two)."""
        n, nl = self.n_nodes, self.n_local
        runs, j = [], 0
        while j < nl:
            src, off = divmod((dst * nl + s + j) % n, nl)
            take = min(nl - off, nl - j)
            runs.append((src, off, take, j))
            j += take
        return runs

    def roll(self, tree: Any, s: int) -> Any:
        """``out[i] = a[(i + s) mod N]`` for every node-stacked tensor of
        ``tree`` (dicts, tuples, packed payloads), all of it in one message to
        each peer."""
        leaves = _tensors(tree)
        s = int(s) % self.n_nodes
        if s == 0 or not leaves:
            return tree
        self._check_local(leaves, "roll")
        row_bytes = sum(_row_bytes(x) for x in leaves)
        if self.world == 1:
            self._count("roll", row_bytes * self.n_local, 0)
            return _refill(tree, [torch.roll(x, -s, 0) for x in leaves])
        mine = self._runs(self.rank, s)
        ops, recv = [], {}
        for dst in range(self.world):
            if dst == self.rank:
                continue
            parts = [_as_bytes(x[off:off + take])
                     for src, off, take, _ in self._runs(dst, s) if src == self.rank
                     for x in leaves]
            if parts:
                # host staging: gloo sends CPU tensors only
                ops.append(dist.P2POp(dist.isend, torch.cat(parts).cpu(),
                                      dist.get_global_rank(self.group, dst), self.group))
        crossed = 0
        for src, _, take, _ in mine:
            if src != self.rank:
                buf = torch.empty(sum(_padded(take * _row_bytes(x)) for x in leaves),
                                  dtype=torch.uint8)
                recv[src] = buf
                crossed += take * row_bytes
                ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(self.group, src),
                                      self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        arrived = {src: buf.to(self.device) for src, buf in recv.items()}
        self._count("roll", row_bytes * self.n_local, crossed)
        out = [torch.empty_like(x) for x in leaves]
        for src, off, take, j in mine:
            if src == self.rank:
                for o, x in zip(out, leaves):
                    o[j:j + take] = x[off:off + take]
                continue
            at = 0
            for o, x in zip(out, leaves):
                o[j:j + take], at = _from_bytes(arrived[src], at, x.dtype,
                                                (take,) + tuple(x.shape[1:]))
        return _refill(tree, out)

    def all_gather(self, tree: Any) -> Any:
        """Every node-stacked tensor of ``tree`` with all N rows, on every
        rank.  On one rank the tree is returned as it is (every row is
        already here); each node still receives N - 1 rows, which the
        node-link count records."""
        leaves = _tensors(tree)
        if not leaves:
            return tree
        self._check_local(leaves, "all_gather")
        row_bytes = sum(_row_bytes(x) for x in leaves)
        node_link = row_bytes * self.n_local * (self.n_nodes - 1)
        if self.world == 1:
            self._count("all_gather", node_link, 0)
            return tree
        mine = torch.cat([_as_bytes(x) for x in leaves]).cpu()
        bufs = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(bufs, mine, group=self.group)
        others = {r: b.to(self.device) for r, b in enumerate(bufs) if r != self.rank}
        self._count("all_gather", node_link,
                    row_bytes * self.n_local * (self.world - 1))
        out, at = [], 0
        for x in leaves:
            full = torch.empty((self.n_nodes,) + tuple(x.shape[1:]), dtype=x.dtype,
                               device=x.device)
            for r in range(self.world):
                rows = slice(r * self.n_local, (r + 1) * self.n_local)
                full[rows] = x if r == self.rank else _from_bytes(
                    others[r], at, x.dtype, tuple(x.shape))[0]
            out.append(full)
            at += _padded(x.numel() * x.element_size())
        return _refill(tree, out)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks (itself on one rank)."""
        if self.world == 1:
            return x
        host = x.detach().cpu().clone()
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=self.group)
        self._count("all_reduce", 0, host.numel() * host.element_size() * (self.world - 1))
        return host.to(x.device)

    def sum_below(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks below this one (zeros on rank 0
        and on one rank), added in rank order: where a sequence lies over
        the ranks in rank order, the counts of what comes before this
        rank's part (a MoE's queue over a batch split on the data ranks)."""
        if self.world == 1:
            return torch.zeros_like(x)
        host = x.detach().cpu().contiguous()
        parts = [torch.empty_like(host) for _ in range(self.world)]
        dist.all_gather(parts, host, group=self.group)
        self._count("all_gather", 0, host.numel() * host.element_size() * (self.world - 1))
        out = torch.zeros_like(host)
        for p in parts[:self.rank]:
            out += p
        return out.to(x.device)

    # -------------------------------------------------------- layout helpers
    def _replicated(self, x: torch.Tensor) -> bool:
        """True for a tensor of all N rows on a multi-rank mesh; on one
        rank shapes cannot tell, and every tensor counts as node rows."""
        return self.world > 1 and x.dim() > 0 and x.shape[0] == self.n_nodes

    def rows(self, tree: Any) -> Any:
        """This rank's rows of the replicated (all-N-row) tensors of
        ``tree``; tensors that hold this rank's rows already pass."""
        if self.world == 1:
            return tree
        return map_tensors(
            lambda x: x[self.lo:self.hi] if x.dim() and x.shape[0] == self.n_nodes else x, tree)

    def full(self, tree: Any, model_dims: Optional[Sequence[Optional[int]]] = None,
             data_dims: Optional[Sequence[Optional[int]]] = None) -> Any:
        """``tree`` with every tensor of this rank's rows gathered to all N
        rows (:meth:`all_gather`); replicated tensors pass.  ``model_dims``
        (on a model axis) gives each tensor's model-sharded dim, or None, in
        the order the tree's tensors are walked, and ``data_dims`` (on a
        data axis) its data-sharded dim: those shards are gathered over the
        model group, then over the data group, first, so every rank gets the
        whole tree."""
        if model_dims is not None and self.model_group is not None:
            tree = _refill(tree, self.model_group.all_gather(_tensors(tree), model_dims))
        if data_dims is not None and self.data_group is not None:
            tree = _refill(tree, self.data_group.all_gather(_tensors(tree), data_dims))
        local = [x for x in _tensors(tree) if not self._replicated(x)]
        if not local:
            return tree
        gathered = iter(_tensors(self.all_gather(local)))
        return map_tensors(lambda x: x if self._replicated(x) else next(gathered), tree)


def make_test_mesh(n_nodes: int, device=None) -> NodeMesh:
    """One rank holding all ``n_nodes`` nodes on ``device`` (CUDA unless
    ``"cpu"`` is asked for): the Simulator's layout, with counted moves."""
    return NodeMesh(n_nodes, group=None, device=device)


def make_group_mesh(n_nodes: int, group=None, device=None, model: int = 1,
                    data: Optional[int] = None) -> NodeMesh:
    """A mesh over an initialized ``torch.distributed`` group (the default
    group when None): with ``model`` = 1, rank r holds nodes ``[r N / W,
    (r + 1) N / W)``; with M > 1, rank ``d M + m`` holds model shard m of
    nodes ``[d N M / W, (d + 1) N M / W)``; with ``data`` = D given, the
    pod x data x model mesh, rank ``p D M + d M + m`` holding model shard m
    and data shard d of nodes ``[p N D M / W, (p + 1) N D M / W)``.  A model
    or data axis makes subgroups, so every rank of ``group`` must call
    this."""
    if not dist.is_initialized():
        raise RuntimeError("make_group_mesh needs an initialized torch.distributed group")
    return NodeMesh(n_nodes, group=group if group is not None else dist.group.WORLD,
                    device=device, model=model, data=data)
