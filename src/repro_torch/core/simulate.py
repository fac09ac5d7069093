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
static executor.

With a ``telemetry`` hub (``repro_torch.telemetry.Telemetry``) the run feeds
it the per-round streams (from each chunk's host copy), analytic link-byte
counters per buffer and channel, ``eval/*`` gauges and, at the end, the
kernel launches of the run.  With ``hub.spans`` each round runs as its two
phases (``make_round_step``'s ``.phases``: the same minibatches and
operations) in fenced ``local`` / ``gossip`` spans, with ``metrics`` and
``eval`` spans beside them.  A hub changes no number the run computes, and
with ``telemetry=None`` the run makes exactly the calls it makes without
this plumbing.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..compression.base import attach_channel_state
from ..compression.channels import AsyncChannel, SeedFn, link_bytes_per_round
from ..device import resolve_device
from ..telemetry.registry import TRAINING_STREAM_FIELDS as STREAM_FIELDS
from ..telemetry.registry import register_training_streams
from ..telemetry.spans import span
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
        telemetry=None,
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
        # an optional hub: streams, link-byte counters and, with hub.spans,
        # fenced per-phase rounds; None leaves every path below as it was
        self.telemetry = telemetry
        if telemetry is not None:
            register_training_streams(telemetry)
        self._link_per_round: Optional[Dict[str, float]] = None
        self._rounds_done = 0   # the external run_rounds() hook's span numbering

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
        and return the state: the hook for callers that interleave training
        with other work.  With a hub the link bytes accumulate here too, and
        with spans on the rounds run phase by phase in fenced spans."""
        if self._round_step is None:
            raise ValueError(
                "this Simulator has no static topology; a scenario's schedule "
                "runs through run()"
            )
        tel, n = self.telemetry, int(n_rounds)
        if tel is not None and tel.spans:
            start = self._rounds_done
            state = self._advance_spanned(state, start, start + n)
        else:
            state = self._rounds(state, n)
            if tel is not None:
                tel.record_link_bytes(self._link_round_bytes(state), rounds=n,
                                      factor=self._send_factor(state))
        if tel is not None:
            self._rounds_done += n
        return state

    def _rounds(self, state, n_rounds: int):
        """``n_rounds`` rounds of the static executor."""
        for _ in range(n_rounds):
            batches = [self._batch(state.step + j) for j in range(self.round_len)]
            state = self._round_step(state, batches)
        return state

    # ------------------------------------------------------------------
    # telemetry plumbing (inert unless a hub is attached)
    # ------------------------------------------------------------------
    def _link_round_bytes(self, state) -> Dict[str, float]:
        """Analytic per-round link bytes per buffer/channel (cached)."""
        if self._link_per_round is None:
            self._link_per_round = link_bytes_per_round(self.alg.comm, state.params)
        return self._link_per_round

    def _has_event_triggered_channel(self) -> bool:
        """True when realized link bytes depend on a measured send mask (an
        active async channel) rather than being statically known."""
        chan = self.alg.comm.resolved_channel()
        if chan is None:
            return False
        return any(
            isinstance(chan.for_buffer(i), AsyncChannel) and not chan.for_buffer(i).is_passthrough
            for i in range(len(self.alg.comm.buffers))
        )

    def _send_factor(self, state) -> float:
        """Measured fraction of nodes that sent this round (async channels;
        1.0 when every declared send happens unconditionally).  Reads one
        value from the device where a channel is event-triggered."""
        if not self._has_event_triggered_channel():
            return 1.0
        from ..scenarios.metrics import send_rate  # lazy: no cycle

        rate = float(send_rate(state))
        return rate if np.isfinite(rate) else 1.0

    def _record_stream_chunk(self, ys: np.ndarray, start_round: int) -> None:
        """Fold one chunk's host copy of the streams (``(len(STREAM_FIELDS),
        rounds)``) into the hub's per-round gauge streams."""
        tel = self.telemetry
        for name, row in zip(STREAM_FIELDS, ys):
            for j, v in enumerate(row):
                tel.record(name, v, step=start_round + j)

    def _spanned_round(self, state, r: int, slots=None, ctx: Optional[RoundCtx] = None):
        """One round through the executor's two phases, each in a fenced
        span: the minibatches and operations of ``round_step``, with the
        last minibatch gathered after the local phase instead of before."""
        tel, rl, s0 = self.telemetry, self.round_len, state.step
        step = self._round_step if ctx is None else self._sched_step
        local_phase, comm_phase = step.phases
        more = () if ctx is None else (ctx,)
        if rl > 1:
            with span(tel, "local", step=r) as sp:
                state = local_phase(state, [self._batch(s0 + j, slots) for j in range(rl - 1)],
                                    *more)
                sp.fence(state)
        with span(tel, "gossip", step=r) as sp:
            state = comm_phase(state, self._batch(s0 + rl - 1, slots), *more)
            sp.fence(state)
        return state

    def _advance_spanned(self, state, start: int, stop: int):
        """Static rounds ``start .. stop - 1`` in fenced phase spans, with
        the link bytes recorded per round."""
        tel = self.telemetry
        link = self._link_round_bytes(state)
        for r in range(start, stop):
            state = self._spanned_round(state, r)
            tel.record_link_bytes(link, rounds=1, factor=self._send_factor(state), step=r)
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
        from ..scenarios.metrics import effective_spectral_gap  # lazy

        rl, tel = self.round_len, self.telemetry
        spanned = tel is not None and tel.spans
        rows = []
        for r in range(start, stop):
            ctx = RoundCtx(
                w=arrays["w"][r], active=arrays["active"][r],
                local_mask=arrays["local_mask"][r], pattern=int(schedule.pattern[r]),
                comp_scale=None if schedule.comp_scale is None else schedule.comp_scale[r],
                trigger=None if schedule.trigger is None else schedule.trigger[r],
            )
            if spanned:
                state = self._spanned_round(state, r, slots, ctx)
            else:
                batches = [self._batch(state.step + j, slots) for j in range(rl)]
                state = self._sched_step(state, batches, ctx)
            if self._stream_fn is not None:
                with span(tel, "metrics", step=r) as sp:
                    rows.append(self._stream_fn(state, ctx))
                    sp.fence(rows[-1])
            if spanned:
                tel.record_link_bytes(self._link_round_bytes(state), rounds=1,
                                      factor=self._send_factor(state), step=r)
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
        tel = self.telemetry
        spans_on = tel is not None and tel.spans

        schedule = slots = None
        if self.scenario is not None:
            schedule = self.scenario.materialize(
                self.n_nodes, n_rounds, rl, batch_size=self.batch_size)
            arrays, slots = self._device_schedule(schedule)
            stream_chunks: List[np.ndarray] = []

        def record(steps_done):
            with span(tel, "eval", step=steps_done):
                m = self.evaluate(state)   # host floats: fenced already
            m["step"] = steps_done
            history.append(m)
            if tel is not None:
                for k, v in m.items():
                    if k != "step":
                        tel.gauge(f"eval/{k}", v, step=steps_done)
            if verbose:
                print(
                    f"  step {steps_done:5d}  "
                    + "  ".join(f"{k}={v:.4f}" for k, v in m.items() if k != "step")
                )

        def advance(state, start, stop):
            if self.scenario is None:
                if spans_on:
                    return self._advance_spanned(state, start, stop)
                state = self._rounds(state, stop - start)
                if tel is not None:
                    tel.record_link_bytes(self._link_round_bytes(state), rounds=stop - start,
                                          factor=self._send_factor(state), step=stop - 1)
                return state
            state, ys = self._run_scheduled(state, schedule, arrays, slots, start, stop)
            if ys is not None:
                ys = ys.cpu().numpy()   # one transfer a chunk
                stream_chunks.append(ys)
            if tel is not None:
                if ys is not None:
                    self._record_stream_chunk(ys, start)
                if not spans_on:   # spanned rounds record their own link bytes
                    factor = 1.0
                    if ys is not None:
                        rate = ys[STREAM_FIELDS.index("send_rate")]
                        if np.isfinite(rate).any():
                            factor = float(np.nanmean(rate))
                    elif self._has_event_triggered_channel():
                        factor = self._send_factor(state)
                    tel.record_link_bytes(self._link_round_bytes(state), rounds=stop - start,
                                          factor=factor, step=stop - 1)
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
            with span(tel, "local", step=n_rounds) as sp:
                state = self._run_local_tail(state, tail, slots)
                sp.fence(state)
            if eval_every:
                record(num_steps)
        if tel is not None:
            tel.record_kernel_launches()
        out = {"state": state, "history": history}
        if self.scenario is not None:
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
