"""N-node decentralized training simulator in PyTorch (one device).

Counterpart of ``repro.core.simulate``.  The reference's ``vmap(grad)``
becomes an explicit node dimension: ``loss_fn(params, batch)`` takes
node-stacked parameters (leaves ``(N, ...)``) and batches (``(N, b, ...)``)
and returns the ``(N,)`` per-node losses.  The gradient is
``torch.autograd.grad`` of their SUM with respect to the stacked
parameters, which equals the per-node gradients because node i's loss
depends only on slice i.

Minibatch indices come from ``index_fn(step) -> LongTensor (N, b)``, called
once per iteration, communication steps included, in iteration order.  By
default it draws with ``torch.randint`` from a device ``torch.Generator``
seeded from ``seed``; parity tests inject the reference's indices.

With an active gossip channel (a lossy codec), the codec's uint32 seeds come
from ``comm_seed_fn(event, buffer, leaf)``.  By default they are derived on
the host from ``seed`` (``np.random.SeedSequence``), so no draw waits on the
device; parity tests replay the reference's key chain and inject it.

With a ``scenario`` (``repro_torch.scenarios.Scenario``) the Simulator runs
the materialized per-round schedule (time-varying W_t, node dropout,
straggler masks, per-node batch sizes, codec knobs) through the scheduled
executor and returns dense per-round metric streams.  The schedule goes to
the device once per run; each round's stream values stay on the device
until the next evaluation point, where a chunk is copied to the host in one
transfer.  The static, fault-free ``baseline`` scenario is bit for bit the
static executor.  Telemetry is a later slice (ROADMAP queue 1 item 6).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..compression.base import attach_channel_state
from ..compression.channels import SeedFn
from ..device import resolve_device
from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from .algorithm import RoundCtx, make_round_step
from .mixing import dense_mix, scheduled_dense_mix
from .topology import Topology

Tree = Any
LossFn = Callable[[Tree, Any], torch.Tensor]   # (stacked params, batch) -> (N,)
IndexFn = Callable[[int], torch.Tensor]        # step -> (N, b) sample indices

__all__ = [
    "NodeData", "Simulator", "node_mean", "consensus_distance", "default_comm_seed_fn",
]

_CHANNEL_TAG = 0x636F   # keeps the codec's seed stream apart from the batches'


def default_comm_seed_fn(seed: int) -> SeedFn:
    """Host-side codec seeds: one uint32 per (event, buffer, leaf), drawn
    from ``np.random.SeedSequence`` keyed on ``seed``."""

    def seed_fn(event: int, buffer: int, leaf: int) -> int:
        entropy = [int(seed), _CHANNEL_TAG, int(event), int(buffer), int(leaf)]
        return int(np.random.SeedSequence(entropy).generate_state(1)[0])

    return seed_fn


def node_mean(tree: Tree) -> Tree:
    """Average over the leading node axis (the paper's x-bar)."""
    return tree_map(lambda x: x.float().mean(dim=0), tree)


def consensus_distance(tree: Tree) -> torch.Tensor:
    """sum_i ||x_i - x_bar||^2 over the whole tree (paper's ||X - X̄||_F^2)."""
    mean = node_mean(tree)

    def one(x, m):
        d = x.float() - m[None]
        return torch.sum(d * d)

    return sum(tree_leaves(tree_map(one, tree, mean)))


def _make_grad_at_mean(full_grad_fn: Callable[[Tree], Tree], n: int):
    """Exact full-batch ∇f(x̄): per-node full gradients at the node mean,
    averaged (shards are rectangular, so the node mean is the global mean)."""

    def grad_at_mean(xbar: Tree) -> Tree:
        stacked = tree_map(lambda p: p.unsqueeze(0).expand((n,) + tuple(p.shape)).contiguous(),
                           xbar)
        return tree_map(lambda g: g.float().mean(dim=0), full_grad_fn(stacked))

    return grad_at_mean


def _node_grad_fn(loss_fn: LossFn) -> Callable[[Tree, Any], Tree]:
    """Per-node gradients: grad of the node-summed loss (slice i of the
    result depends only on node i's loss)."""

    def vgrad(params: Tree, batch) -> Tree:
        leaves, treedef = tree_flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss = loss_fn(tree_unflatten(treedef, leaves), batch).sum()
            grads = torch.autograd.grad(loss, leaves)
        return tree_unflatten(treedef, list(grads))

    return vgrad


@dataclasses.dataclass
class NodeData:
    """Per-node datasets: features (N, n_i, ...), labels (N, n_i, ...).

    ``n_dropped`` records samples discarded by rectangular truncation in
    ``partition_to_node_data`` (0 for exact partitions)."""

    x: np.ndarray
    y: np.ndarray
    n_dropped: int = 0

    @property
    def n_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def samples_per_node(self) -> int:
        return self.x.shape[1]


class Simulator:
    """Runs a ``DecentralizedAlgorithm`` over a simulated N-node network.

    ``topology`` may be None when a ``scenario`` is given: the scenario's
    schedule supplies every round's W_t.  A topology given with a scenario
    must equal the scenario's round-0 W (it is otherwise ignored)."""

    def __init__(
        self,
        algorithm,
        topology: Optional[Topology],
        loss_fn: LossFn,
        data: NodeData,
        batch_size: int,
        eval_fn: Optional[Callable[[Tree], Dict[str, float]]] = None,
        scenario=None,
        stream_metrics: bool = True,
        *,
        device=None,
        seed: int = 0,
        index_fn: Optional[IndexFn] = None,
        comm_seed_fn: Optional[SeedFn] = None,
    ):
        self.device = resolve_device(device)
        if topology is None and scenario is None:
            raise ValueError("need a topology, a scenario, or both")
        n = data.n_nodes if topology is None else topology.n
        if data.n_nodes != n:
            raise ValueError(f"data has {data.n_nodes} nodes, topology has {n}")
        self.alg = algorithm
        self.topology = topology
        self.loss_fn = loss_fn
        self.data = data
        self.batch_size = batch_size
        self.eval_fn = eval_fn
        self.scenario = scenario
        self.stream_metrics = stream_metrics
        self.n_nodes = n
        self.mix_fn = dense_mix(topology.w, self.device) if topology is not None else None

        dev = self.device
        self._x = torch.as_tensor(data.x, device=dev)
        self._y = torch.as_tensor(data.y, device=dev).long()
        self._rows = torch.arange(n, device=dev)[:, None]
        self._full_flat = (
            self._x.reshape((1, -1) + tuple(data.x.shape[2:])),
            self._y.reshape((1, -1) + tuple(data.y.shape[2:])),
        )
        if index_fn is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            n_i = data.samples_per_node

            def index_fn(step):
                return torch.randint(0, n_i, (n, batch_size), generator=gen, device=dev)

        self.index_fn = index_fn
        self.comm_seed_fn = comm_seed_fn or default_comm_seed_fn(seed)

        # the step functions close over the loss and the data, never over
        # self: a bound method stored on self would make every Simulator a
        # reference cycle that keeps its device data until the collector runs
        self._vgrad = vgrad = _node_grad_fn(loss_fn)
        x, y = self._x, self._y
        self._full_grad_fn = full_grad_fn = lambda params: vgrad(params, (x, y))
        self._grad_at_mean = _make_grad_at_mean(full_grad_fn, n)
        if self.mix_fn is not None:
            self._round_step, self.round_len = make_round_step(
                algorithm, self.mix_fn,
                grad_of_batch=vgrad,
                full_grad_fn=full_grad_fn,
                comm_seed_fn=self.comm_seed_fn,
            )
        else:
            self._round_step = None
            self.round_len = algorithm.comm.round_len(getattr(algorithm, "tau", 1))

        # ---- scenario engine: the scheduled executor and its streams ----
        self._sched_step = self._stream_fn = None
        if scenario is not None:
            from ..scenarios.metrics import make_stream_fn  # lazy: no cycle

            scenario.warn_if_vacuous(self.round_len)
            if topology is not None:
                # the scheduled path is the only one that runs: a topology
                # that disagrees with the scenario's round-0 graph would be
                # silently ignored, so reject it
                w0, _ = scenario.topology_schedule(n).generate(
                    1, np.random.default_rng(scenario.seed))
                if not np.allclose(w0[0], topology.w, atol=1e-6):
                    raise ValueError(
                        f"topology {topology.name!r} disagrees with scenario "
                        f"{scenario.name!r} (round-0 W differs); pass "
                        "topology=None to train on the scenario's schedule"
                    )
            self._sched_step, _ = make_round_step(
                algorithm, scheduled_dense_mix(),
                grad_of_batch=vgrad,
                full_grad_fn=full_grad_fn,
                comm_seed_fn=self.comm_seed_fn,
                scheduled=True,
                gate_local=scenario.needs_local_gate,
                gate_active=scenario.needs_active_gate,
            )
            if stream_metrics:
                # the spectral gap depends on (W_t, a) alone: run() computes
                # a chunk's gaps in one batched call
                self._stream_fn = make_stream_fn(
                    self._grad_at_mean,
                    buffer_name=getattr(algorithm, "tracking_buffer", None),
                    comm_buffers=algorithm.comm.buffers,
                    spectral_gap=False,
                )

    # ------------------------------------------------------------------
    def _batch(self, step: int, slots: Optional[torch.Tensor] = None):
        """The minibatch of iteration ``step``: (x (N, b, ...), y (N, b)).

        ``slots`` (N, b) shrinks node i's effective batch to b_i draws,
        tiled cyclically over the b slots (``slots[i] = arange(b) % b_i``):
        sampling is with replacement, so the slot mean is a size-b_i
        minibatch mean, and b_i = b is the identity gather."""
        idx = self.index_fn(step).to(device=self.device, dtype=torch.long)
        if slots is not None:
            idx = torch.gather(idx, 1, slots)
        return self._x[self._rows, idx], self._y[self._rows, idx]

    # ------------------------------------------------------------------
    def init_state(self, params: Tree):
        """Broadcast identical x_0 to all nodes (paper: x_0^{(i)} = x_0).
        With an active gossip channel the per-buffer wire state is attached
        (``comp``); otherwise the state is the algorithm's own."""
        stacked = tree_map(
            lambda p: p.to(self.device).unsqueeze(0).repeat((self.n_nodes,) + (1,) * p.dim()),
            params,
        )
        return attach_channel_state(self.alg, self.alg.init(stacked, self._full_grad_fn))

    def run_rounds(self, state, n_rounds: int = 1):
        """Advance ``n_rounds`` communication rounds of the static topology
        and return the state."""
        if self._round_step is None:
            raise ValueError(
                "this Simulator has no static topology; a scenario's schedule "
                "runs through run()"
            )
        for _ in range(int(n_rounds)):
            batches = [self._batch(state.step + j) for j in range(self.round_len)]
            state = self._round_step(state, batches)
        return state

    def _run_local_tail(self, state, n_steps: int, slots=None):
        """Trailing local-only steps when num_steps % round_len != 0 (fault
        free, with the scenario's per-node batch sizes)."""
        for _ in range(int(n_steps)):
            batch = self._batch(state.step, slots)
            state = self.alg.local_update(state, lambda p: self._vgrad(p, batch))
        return state

    # ------------------------------------------------------------------
    def _device_schedule(self, schedule):
        """The schedule's per-round arrays on the device, copied once: W_t
        in fp32, the masks as bool; the per-node batch sizes as (N, b) gather
        slots.  The knobs stay on the host."""
        dev = self.device
        arrays = {
            "w": torch.as_tensor(np.asarray(schedule.w, np.float32)).to(dev),
            "active": torch.as_tensor(schedule.active).to(dev),
            "local_mask": torch.as_tensor(schedule.local_mask).to(dev),
        }
        slots = None
        if schedule.batch_sizes is not None:
            b = torch.as_tensor(np.asarray(schedule.batch_sizes, np.int64))
            slots = (torch.arange(self.batch_size)[None, :] % b[:, None]).to(dev)
        return arrays, slots

    def _run_scheduled(self, state, schedule, arrays, slots, start: int, stop: int):
        """Rounds ``start .. stop - 1`` of the schedule; returns the state
        and the chunk's streams, ``(len(STREAM_FIELDS), rounds)`` fp32 on the
        device (None without streams)."""
        from ..scenarios.metrics import STREAM_FIELDS, effective_spectral_gap  # lazy

        rl = self.round_len
        rows = []
        for r in range(start, stop):
            batches = [self._batch(state.step + j, slots) for j in range(rl)]
            ctx = RoundCtx(
                w=arrays["w"][r], active=arrays["active"][r],
                local_mask=arrays["local_mask"][r], pattern=int(schedule.pattern[r]),
                comp_scale=None if schedule.comp_scale is None else schedule.comp_scale[r],
                trigger=None if schedule.trigger is None else schedule.trigger[r],
            )
            state = self._sched_step(state, batches, ctx)
            if self._stream_fn is not None:
                rows.append(self._stream_fn(state, ctx))
        if not rows:
            return state, None
        gaps = effective_spectral_gap(arrays["w"][start:stop], arrays["active"][start:stop])
        ys = torch.stack([
            gaps if k == "spectral_gap" else torch.stack([row[k] for row in rows])
            for k in STREAM_FIELDS
        ])
        return state, ys

    # ------------------------------------------------------------------
    def run(
        self,
        params: Tree,
        num_steps: int,
        eval_every: int = 0,
        verbose: bool = False,
    ) -> Dict[str, Any]:
        """Run ``num_steps`` iterations; evaluate every ``eval_every`` steps.

        Evaluation points snap forward to communication-round boundaries; a
        final evaluation at ``num_steps`` is always emitted when
        ``eval_every > 0``.

        With a scenario the run follows its materialized schedule and the
        result also carries ``"streams"`` (a numpy fp32 array of shape
        ``(rounds,)`` per stream field; empty with ``stream_metrics=False``)
        and ``"schedule"``.  The trailing ``num_steps % round_len`` local
        steps run fault free, with the scenario's per-node batch sizes.
        """
        state = self.init_state(params)
        history: List[Dict[str, float]] = []
        rl = self.round_len
        n_rounds, tail = divmod(num_steps, rl)

        schedule = slots = None
        if self.scenario is not None:
            schedule = self.scenario.materialize(
                self.n_nodes, n_rounds, rl, batch_size=self.batch_size)
            arrays, slots = self._device_schedule(schedule)
            stream_chunks: List[np.ndarray] = []

        def record(steps_done):
            m = self.evaluate(state)
            m["step"] = steps_done
            history.append(m)
            if verbose:
                print(
                    f"  step {steps_done:5d}  "
                    + "  ".join(f"{k}={v:.4f}" for k, v in m.items() if k != "step")
                )

        def advance(state, start, stop):
            if self.scenario is None:
                return self.run_rounds(state, stop - start)
            state, ys = self._run_scheduled(state, schedule, arrays, slots, start, stop)
            if ys is not None:
                stream_chunks.append(ys.cpu().numpy())   # one transfer a chunk
            return state

        # a round is an eval boundary when an eval point (a multiple of
        # eval_every) falls inside it; mid-round points snap FORWARD to the
        # round end
        eval_rounds = sorted(
            {
                r
                for r in range(1, n_rounds + 1)
                if eval_every
                and (r * rl) // eval_every > ((r - 1) * rl) // eval_every
            }
            | ({n_rounds} if n_rounds and eval_every and not tail else set())
        )
        done = 0
        for boundary in eval_rounds:
            state = advance(state, done, boundary)
            done = boundary
            record(boundary * rl)
        if done < n_rounds:
            state = advance(state, done, n_rounds)
        if tail:
            state = self._run_local_tail(state, tail, slots)
            if eval_every:
                record(num_steps)
        out = {"state": state, "history": history}
        if self.scenario is not None:
            from ..scenarios.metrics import STREAM_FIELDS  # lazy

            streams: Dict[str, np.ndarray] = {}
            if stream_chunks:
                cat = np.concatenate(stream_chunks, axis=1)
                streams = {k: cat[i] for i, k in enumerate(STREAM_FIELDS)}
            out["streams"] = streams
            out["schedule"] = schedule
        return out

    # ------------------------------------------------------------------
    def _eval_loss_gnorm(self, xbar: Tree):
        """Full-batch loss and squared gradient norm at the node mean."""
        leaves, treedef = tree_flatten(xbar)
        leaves = [p.detach().unsqueeze(0).requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss = self.loss_fn(tree_unflatten(treedef, leaves), self._full_flat)[0]
            grads = torch.autograd.grad(loss, leaves)
        gnorm = sum(torch.sum(g.float() ** 2) for g in grads)
        return loss.detach(), gnorm

    def evaluate(self, state) -> Dict[str, float]:
        """Full-batch metrics at the node mean (host floats)."""
        xbar = node_mean(state.params)
        loss, gnorm = self._eval_loss_gnorm(xbar)
        out = {
            "train_loss": float(loss),
            "grad_norm_sq": float(gnorm),
            "consensus": float(consensus_distance(state.params)),
        }
        if self.eval_fn is not None:
            out.update(self.eval_fn(xbar))
        return out
