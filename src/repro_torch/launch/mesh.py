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

from typing import Any, Dict, List, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..tree import map_tensors

__all__ = ["NodeMesh", "make_test_mesh", "make_group_mesh", "OPS"]

#: the three primitives, the keys of :meth:`NodeMesh.byte_counts`
OPS = ("roll", "all_gather", "all_reduce")


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


class NodeMesh:
    """``n_nodes`` nodes over the ranks of ``group`` (None: world 1, every
    node on this process's device).

    ``lo`` / ``hi`` bound this rank's node rows; ``n_local = hi - lo``.
    Tensors are node-stacked on ``device``; host staging is explicit (see
    the module docstring)."""

    def __init__(self, n_nodes: int, group=None, device=None):
        self.n_nodes = int(n_nodes)
        self.group = group
        if group is None:
            self.world, self.rank = 1, 0
        else:
            backend = dist.get_backend(group)
            if backend != "gloo":
                raise NotImplementedError(
                    f"a node mesh over the {backend!r} backend (more than one card, "
                    "NCCL) is ROADMAP queue 1 item 8 (b); the port's mesh runs on gloo")
            self.world = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
        if self.n_nodes < 1 or self.n_nodes % self.world:
            raise ValueError(f"{self.n_nodes} nodes do not split over {self.world} ranks")
        self.n_local = self.n_nodes // self.world
        self.lo = self.rank * self.n_local
        self.hi = self.lo + self.n_local
        self.device = resolve_device(device)
        self.reset_bytes()

    def __repr__(self) -> str:
        return (f"NodeMesh(n_nodes={self.n_nodes}, world={self.world}, rank={self.rank}, "
                f"rows=[{self.lo}, {self.hi}), device={self.device})")

    # ---------------------------------------------------------- accounting
    def reset_bytes(self) -> None:
        self._bytes = {op: {"node_link": 0, "process": 0} for op in OPS}

    def byte_counts(self) -> Dict[str, Dict[str, int]]:
        """``{primitive: {"node_link": B, "process": B}}`` received by this
        rank's nodes since the last :meth:`reset_bytes`."""
        return {op: dict(c) for op, c in self._bytes.items()}

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
                ops.append(dist.P2POp(dist.isend, torch.cat(parts).cpu(), dst, self.group))
        crossed = 0
        for src, _, take, _ in mine:
            if src != self.rank:
                buf = torch.empty(sum(_padded(take * _row_bytes(x)) for x in leaves),
                                  dtype=torch.uint8)
                recv[src] = buf
                crossed += take * row_bytes
                ops.append(dist.P2POp(dist.irecv, buf, src, self.group))
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

    def full(self, tree: Any) -> Any:
        """``tree`` with every tensor of this rank's rows gathered to all N
        rows (:meth:`all_gather`); replicated tensors pass."""
        local = [x for x in _tensors(tree) if not self._replicated(x)]
        if not local:
            return tree
        gathered = iter(_tensors(self.all_gather(local)))
        return map_tensors(lambda x: x if self._replicated(x) else next(gathered), tree)


def make_test_mesh(n_nodes: int, device=None) -> NodeMesh:
    """One rank holding all ``n_nodes`` nodes on ``device`` (CUDA unless
    ``"cpu"`` is asked for): the Simulator's layout, with counted moves."""
    return NodeMesh(n_nodes, group=None, device=device)


def make_group_mesh(n_nodes: int, group=None, device=None) -> NodeMesh:
    """A mesh over an initialized ``torch.distributed`` group (the default
    group when None): rank r holds nodes ``[r N / W, (r + 1) N / W)``."""
    if not dist.is_initialized():
        raise RuntimeError("make_group_mesh needs an initialized torch.distributed group")
    return NodeMesh(n_nodes, group=group if group is not None else dist.group.WORLD,
                    device=device)
