"""Per-worker execution engine: the one round executor, split at the gather.

Counterpart of ``repro.runtime.engine``.  A worker advances the SAME
scheduled round executor the Simulator runs (``repro_torch.core.
make_round_step`` with ``scheduled=True``), called as its two phases
(``.phases``, which the Simulator's telemetry spans already hold bit for bit
to the whole round): the local phase (tau-1 local updates) runs on the
worker's own state, then the round's cross-node gather assembles the full
post-local state from every owner before the comm phase mixes it.  Eager
PyTorch, no compilation: on CUDA tensors every fused op of the run launches
its hand-written kernel in the worker's own process.

Bit-identity strategy:

  * every worker runs the FULL N-row program -- same shapes, same
    operations as the Simulator -- with the data rows it does not own
    zeroed (``problems.localize``).  Every op on this path is row-local
    (batched matmuls over the node axis, the fused elementwise kernels, the
    top-k codec's per-row pack), so owned rows come out bitwise the
    Simulator's and the other rows finite garbage;
  * the per-round GATHER overwrites every node-stacked state row with its
    owner's true row (dead nodes: the coordinator's frozen canonical row)
    before the comm phase, so mixing -- the only cross-row computation --
    reads exactly the Simulator's inputs;
  * the renormalized W_t zeroes inactive columns and ``_select_nodes``
    discards inactive rows, so neither frozen rows nor the garbage
    ``reset_grad_fn`` rows of non-owned data can leak into an active row.

Randomness is a pure function of the step, so nothing but the step crosses
the wire: the minibatch indices of iteration ``s`` are
:func:`index_stream`'s draw for ``(seed, s)`` and the codec seeds come from
``default_comm_seed_fn(seed)``.  The "key" of the protocol and of the resync
bundle is the committed step, an int64.

Wire encoding of a state goes through the checkpoint's own flatten
(``_flatten_with_paths`` / ``_to_numpy`` / ``_rebuild``): the leaves, their
order, the stacked mask and the ``['fly']`` mask all come from that one
rule, and the host ints ride along -- the step counter as a 0-d int32, a
channel's ``event`` as the uint32 pair ``[0, event]`` -- so a resynced
worker continues the codec's seed stream where the group is.
"""
from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

from ..checkpoint.checkpoint import _EventKey, _flatten_with_paths, _rebuild, _to_numpy
from ..compression.base import attach_channel_state
from ..compression.channels import ChocoChannel
from ..core import RoundCtx, make_algorithm, make_round_step
from ..core.mixing import scheduled_dense_mix
from ..core.simulate import _node_grad_fn, default_comm_seed_fn
from ..device import resolve_device
from ..tree import tree_map
from .config import RuntimeConfig, owned_nodes
from .problems import localize, make_problem

__all__ = [
    "WorkerEngine", "wire_leaves", "restore_wire_leaves", "packed_transport", "index_stream",
]


def packed_transport(algorithm) -> bool:
    """Whether this algorithm's rounds can ride the PACKED socket protocol:
    every gossiped buffer drives an overlap (double-buffered) choco-family
    channel, so the only cross-worker state a round needs is the previous
    round's encoded payload (the channel wire's ``"fly"`` entry) -- known at
    round START and broadcast in the ROUND message, eliminating the dense
    contrib/gather exchange entirely.

    Derived from the algorithm spec alone, so the coordinator and every
    worker -- each holding the same :class:`RuntimeConfig` -- agree without
    negotiation."""
    chan = algorithm.comm.resolved_channel()
    if chan is None:
        return False
    buffers = (
        chan.channels if hasattr(chan, "channels") else (chan,) * len(algorithm.comm.buffers)
    )
    return all(isinstance(c, ChocoChannel) and c.overlap for c in buffers)


def index_stream(seed: int, n_nodes: int, samples_per_node: int, batch_size: int, device):
    """``index_fn(step) -> LongTensor (N, b)``: the minibatch indices of
    iteration ``step``, a pure function of ``(seed, step)`` -- a fresh
    ``torch.Generator`` on ``device`` seeded from ``np.random.SeedSequence([
    seed, step])``, then one ``torch.randint`` over the full (N, b) shape.
    A re-issued round and a resynced worker redraw the same indices with no
    generator state to ship; the replay hands the same function to the
    Simulator's ``index_fn`` hook."""
    dev = torch.device(device)

    def index_fn(step: int) -> torch.Tensor:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(np.random.SeedSequence([int(seed), int(step)])
                            .generate_state(1, np.uint64)[0]))
        return torch.randint(0, samples_per_node, (n_nodes, batch_size), generator=gen,
                             device=dev)

    return index_fn


def wire_leaves(tree: Any) -> List[np.ndarray]:
    """Flatten a state to host numpy arrays, in the checkpoint's leaf order."""
    return [_to_numpy(v) for _, v in _flatten_with_paths(tree)]


def _from_wire(arr: np.ndarray, like: Any) -> Any:
    """One wire array as the leaf ``like`` is: a tensor of its dtype on its
    device, a channel event as a 0-d tensor (``_rebuild`` reads it back into
    the ChannelState), a host int as an int."""
    if isinstance(like, _EventKey):
        return torch.tensor(int(np.asarray(arr).reshape(-1)[-1]))
    if isinstance(like, torch.Tensor):
        a = np.asarray(arr)
        if like.dtype == torch.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(like.device)
        return torch.from_numpy(np.array(a, copy=True)).to(like.device)
    return int(np.asarray(arr))


def _kept(leaf: Any) -> Any:
    """A leaf handed back to ``_rebuild`` unchanged."""
    return torch.tensor(int(leaf)) if isinstance(leaf, _EventKey) else leaf


def _replace(template: Any, mask: Sequence[bool], arrays: Sequence[np.ndarray],
             what: str) -> Any:
    """``template`` with the leaves under ``mask`` replaced, in order, by
    ``arrays``."""
    leaves = [v for _, v in _flatten_with_paths(template)]
    it = iter(arrays)
    out = [_from_wire(next(it), leaf) if m else _kept(leaf) for leaf, m in zip(leaves, mask)]
    rest = sum(1 for _ in it)
    if rest:
        raise ValueError(f"{rest} {what} arrays beyond the leaves they replace")
    return _rebuild(template, iter(out))


def restore_wire_leaves(template: Any, arrays: Sequence[np.ndarray]) -> Any:
    """Rebuild a state of ``template``'s structure from wire arrays."""
    n = len(_flatten_with_paths(template))
    if len(arrays) != n:
        raise ValueError(f"wire state has {len(arrays)} leaves, template has {n}")
    return _replace(template, [True] * n, arrays, "wire")


class WorkerEngine:
    """Builds the problem + algorithm from a :class:`RuntimeConfig` on
    ``config.device`` (CUDA unless the config asks for the CPU) and exposes
    the three round drivers plus the wire/gather helpers."""

    def __init__(self, config: RuntimeConfig, worker_id: int, n_workers: int):
        self.config = config
        self.device = dev = resolve_device(config.device)
        self.worker_id = int(worker_id)
        self.n_workers = int(n_workers)
        self.owned = owned_nodes(config.n_nodes, n_workers, worker_id)
        problem = make_problem(config.problem, config.n_nodes, config.seed)
        self.loss_fn = problem.loss_fn
        self.init_params = problem.init_params
        self.data = localize(problem.data, self.owned)
        self.batch_size = int(config.batch_size)
        self.n_nodes = n = int(config.n_nodes)

        self.alg = make_algorithm(config.algorithm, **config.hyperparams)
        # the Simulator's tensors and gradient, over the localized data
        self._x = x = torch.as_tensor(self.data.x, device=dev)
        self._y = y = torch.as_tensor(self.data.y, device=dev).long()
        self._rows = torch.arange(n, device=dev)[:, None]
        self._owned_t = torch.as_tensor(np.asarray(self.owned), device=dev)
        vgrad = _node_grad_fn(self.loss_fn)
        self._full_grad_fn = lambda p: vgrad(p, (x, y))
        self.index_fn = index_stream(config.seed, n, self.data.samples_per_node,
                                     self.batch_size, dev)
        self.comm_seed_fn = default_comm_seed_fn(config.seed)

        # membership can always change under the elastic runtime, so both
        # gates are on -- matching a replay scenario built on RecordedFaults
        # (gates_local = gates_active = True)
        step, self.round_len = make_round_step(
            self.alg, scheduled_dense_mix(),
            grad_of_batch=vgrad,
            full_grad_fn=self._full_grad_fn,
            comm_seed_fn=self.comm_seed_fn,
            scheduled=True, gate_local=True, gate_active=True,
        )
        self._local_phase, self._comm_phase = step.phases

    def _batch(self, step: int):
        """The minibatch of iteration ``step``: the Simulator's gather."""
        idx = self.index_fn(step)
        return self._x[self._rows, idx], self._y[self._rows, idx]

    # ------------------------------------------------------------------
    def init_state(self) -> Tuple[Any, int]:
        """(state_0, step 0): broadcast x_0, algorithm init, channel state --
        ``Simulator.init_state`` on the same initial parameters."""
        params = self.init_params(self.config.seed)
        stacked = tree_map(
            lambda p: p.to(self.device).unsqueeze(0).repeat((self.n_nodes,) + (1,) * p.dim()),
            params,
        )
        state = attach_channel_state(self.alg, self.alg.init(stacked, self._full_grad_fn))
        return state, 0

    # ------------------------------------------------------------------
    def stacked_mask(self, state: Any) -> List[bool]:
        """Which state leaves carry a leading node axis -- decided on the
        tensors (``_select_nodes``'s own rule), never on wire shapes."""
        return [
            isinstance(v, torch.Tensor) and v.dim() > 0 and v.shape[0] == self.n_nodes
            for _, v in _flatten_with_paths(state)
        ]

    def owned_rows(self, state: Any) -> List[np.ndarray]:
        """Wire arrays of this worker's owned rows of every stacked leaf."""
        return [
            _to_numpy(v[self._owned_t])
            for (_, v), m in zip(_flatten_with_paths(state), self.stacked_mask(state)) if m
        ]

    def owned_batch(self, batch) -> Tuple[np.ndarray, ...]:
        """This worker's owned rows of a full-shape minibatch, on the host."""
        return tuple(b[self._owned_t].cpu().numpy() for b in batch)

    def set_stacked(self, state: Any, arrays: Sequence[np.ndarray]) -> Any:
        """Replace every node-stacked leaf with a gathered full array."""
        return _replace(state, self.stacked_mask(state), arrays, "gathered")

    # -- packed (wire-true) transport ----------------------------------
    def fly_mask(self, state: Any) -> List[bool]:
        """Which state leaves are the channel wire's in-flight message (the
        ``"fly"`` entries of ``state.comp.wire``) -- the ONLY cross-worker
        state a packed round moves.  Positional over the checkpoint's flat
        leaves, the same convention as :meth:`stacked_mask`."""
        return ["['fly']" in path for path, _ in _flatten_with_paths(state)]

    def fly_rows(self, state: Any) -> List[np.ndarray]:
        """Wire arrays of this worker's owned rows of every fly leaf (all
        fly leaves are node-stacked: packed payloads and send masks)."""
        out = []
        for (_, v), m in zip(_flatten_with_paths(state), self.fly_mask(state)):
            if not m:
                continue
            if not isinstance(v, torch.Tensor) or v.dim() == 0 or v.shape[0] != self.n_nodes:
                raise ValueError(f"fly leaf {v!r} is not node-stacked")
            out.append(_to_numpy(v[self._owned_t]))
        return out

    def set_fly(self, state: Any, arrays: Sequence[np.ndarray]) -> Any:
        """Overwrite the fly leaves with the coordinator's canonical packed
        payload (full N-row arrays, broadcast in the ROUND message)."""
        return _replace(state, self.fly_mask(state), arrays, "payload")

    def scalar_leaves(self, state: Any) -> List[np.ndarray]:
        """Wire arrays of every NON-stacked leaf (the step counter, the
        channel's event) -- these advance identically on all workers, so the
        coordinator takes them from the lead DONE on snapshot rounds."""
        return [
            _to_numpy(v)
            for (_, v), m in zip(_flatten_with_paths(state), self.stacked_mask(state)) if not m
        ]

    # ------------------------------------------------------------------
    def run_local(self, state: Any, key: int, local_mask: np.ndarray):
        """(post_local_state, key) after the tau-1 masked local updates of
        the round that starts at step ``key``."""
        rl = self.round_len
        if rl == 1:
            return state, key
        micro = [self._batch(key + j) for j in range(rl - 1)]
        ctx = RoundCtx(local_mask=torch.as_tensor(np.asarray(local_mask), device=self.device))
        return self._local_phase(state, micro, ctx), key + rl - 1

    def sample_comm_batch(self, key: int):
        """(key', last_batch): the round-closing step's full-shape sample."""
        return key + 1, self._batch(key)

    def run_comm(self, state: Any, last_batch, schedule_row) -> Any:
        """Close the round on the ASSEMBLED state/batch with this round's
        live-membership context."""
        w, active, lm, pattern, comp_scale, trigger = schedule_row
        dev = self.device
        ctx = RoundCtx(
            w=torch.as_tensor(np.asarray(w, np.float32), device=dev),
            active=torch.as_tensor(np.asarray(active), device=dev),
            local_mask=torch.as_tensor(np.asarray(lm), device=dev),
            pattern=int(pattern),
            comp_scale=comp_scale,
            trigger=trigger,
        )
        last = tuple(torch.as_tensor(b, device=dev) for b in last_batch)
        return self._comm_phase(state, last, ctx)
