"""Algorithm interface of the port: ``DecentralizedAlgorithm`` + ``CommSpec``.

Counterpart of ``repro.core.algorithm``.  Every method factors into

    init(params, full_grad_fn=None)                    -> state
    local_update(state, grad_fn)                       -> state   # no comm
    comm_update(state, mix_fn, grad_fn, reset_grad_fn) -> state   # gossip step

plus a declarative :class:`CommSpec` naming which buffers are gossiped, on
what cadence, which gradient resets the direction estimate, and how the
messages move on the wire (``compression``, ``channel``).
:func:`make_round_step` is the one round executor the Simulator drives.

Gossip runs through ``repro_torch.compression``: the codecs (identity,
qsgd, top_k, rand_k, low_rank), the sync, choco and async channels,
per-buffer channel mappings and comm/compute overlap, on the Simulator's
dense engine or the sharded engine's transports (``compressed_combine``,
``transport_hooks``).  With ``scheduled=True`` the executor takes the
scenario engine's per-round :class:`RoundCtx` (W_t, node dropout,
straggler masks, codec knobs).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from ..compression.base import make_compressor
from ..compression.base import Packed
from ..compression.channels import (
    ChannelSession, ChocoChannel, PerBufferChannel, SeedFn, SyncChannel, Transport,
    make_channel,
)

Tree = Any
GradFn = Callable[[Tree], Tree]       # params -> grads (batch closed over)
MixFn = Callable[[Tree], Tree]        # gossip: tree -> mixed tree

__all__ = ["CommSpec", "DecentralizedAlgorithm", "RoundCtx", "make_round_step"]

CADENCES = ("every_step", "every_tau")
RESETS = ("none", "minibatch", "full")


@dataclasses.dataclass(frozen=True)
class CommSpec:
    """Declarative communication schedule of a decentralized algorithm.

    cadence:  "every_step" (gossip every iteration; no ``local_update``) or
              "every_tau" (tau-1 local updates, then one ``comm_update``
              closes the round).
    buffers:  names of the param-sized messages gossiped per communication
              event, in the order ``comm_update`` mixes them (wire state is
              matched to the k-th ``mix_fn`` call positionally).
    reset:    the gradient the executor hands ``comm_update`` as
              ``reset_grad_fn``: "full" (full local gradient, the DSE-MVR
              v-reset), "minibatch" (fresh minibatch gradient, DSE-SGD) or
              "none".
    compression: the wire codec: None, a registry name ("identity",
              "qsgd", "top_k:0.1", "rand_k:0.25", "low_rank:2"; lossy codecs
              are error-feedback-wrapped by default) or a ``Compressor``.
              None and "identity" take the exact uncompressed gossip path.
    channel:  the gossip protocol: None or "sync", "choco" (``"choco:0.8"``
              sets the consensus step), "async" (``"async:2"`` sets the
              staleness bound), a ``GossipChannel``, or a ``{buffer_name:
              spec}`` mapping (unlisted buffers stay "sync").  Difference
              channels drop the error-feedback default (the replica is the
              memory).
    overlap:  comm/compute overlap: double-buffer the sends of a choco or
              async channel on every buffer; each round applies the
              previous round's message (async needs ``max_staleness >= 2``).
    """

    cadence: str = "every_tau"
    buffers: Tuple[str, ...] = ("params",)
    reset: str = "none"
    compression: Any = None
    channel: Any = None
    overlap: bool = False

    def __post_init__(self):
        if self.cadence not in CADENCES:
            raise ValueError(f"cadence {self.cadence!r} not in {CADENCES}")
        if self.reset not in RESETS:
            raise ValueError(f"reset {self.reset!r} not in {RESETS}")
        if self.compression is not None:
            object.__setattr__(self, "compression", make_compressor(self.compression))
        if self.channel is not None:
            chan = self.channel
            if isinstance(chan, dict):
                unknown = sorted(set(chan) - set(self.buffers))
                if unknown:
                    raise ValueError(
                        f"per-buffer channel mapping names unknown buffers "
                        f"{unknown}; declared buffers: {self.buffers}"
                    )
                chan = PerBufferChannel(channels=tuple(
                    make_channel(chan.get(b, "sync")) for b in self.buffers
                ))
            else:
                chan = make_channel(chan)
            object.__setattr__(self, "channel", chan.bind(self.compression))
        if self.overlap:
            chan = self.channel
            if chan is None:
                raise ValueError(
                    "overlap=True double-buffers a stateful channel's sends; set "
                    "channel='choco' or 'async:k' (sync gossip has no replica to mix "
                    "against while the message is in flight)"
                )

            def _ov(c):
                if not isinstance(c, ChocoChannel):
                    raise ValueError(
                        "overlap=True requires a difference or stale-mix channel "
                        f"(choco/async) per buffer, got {c.name!r}"
                    )
                return c if c.overlap else dataclasses.replace(c, overlap=True)

            if isinstance(chan, PerBufferChannel):
                chan = dataclasses.replace(chan, channels=tuple(_ov(c) for c in chan.channels))
            else:
                chan = _ov(chan)
            object.__setattr__(self, "channel", chan)

    def round_len(self, tau: int) -> int:
        """Steps per communication round (1 for every-step methods)."""
        return 1 if self.cadence == "every_step" else max(int(tau), 1)

    def comm_events_per_round(self, tau: int) -> int:
        """Communication events in a window of ``tau`` iterations."""
        return tau if self.cadence == "every_step" else 1

    def active_compression(self):
        """The codec the executor must honor (None for identity, which
        short-circuits to the uncompressed path)."""
        comp = self.compression
        if comp is None or comp.is_identity:
            return None
        return comp

    def resolved_channel(self):
        """The channel the executor must drive, or None when the plain
        gossip path applies: the one is-it-active rule shared by the
        executor and state attachment.  A bare codec implies sync."""
        chan = self.channel
        if chan is not None:
            return None if chan.is_passthrough else chan
        comp = self.active_compression()
        return None if comp is None else SyncChannel(compression=comp)


@dataclasses.dataclass
class RoundCtx:
    """One communication round's context under the scenario engine.

    The device tensors are slices of the schedule, copied to the device once
    per run; the knobs stay on the host, so no codec decision waits on the
    device.  A static, fault-free scenario carries the same W, all-true
    masks and no knobs every round, and then the scheduled executor is bit
    for bit the static one.

    w:          (N, N) fp32 mixing matrix W_t.
    active:     (N,) bool: nodes that take part in the round at all.  An
                inactive node keeps its whole state (dropout); W_t is
                renormalized upstream so the active block stays doubly
                stochastic.
    local_mask: (L, N) bool, L >= round_len - 1: per-(local step, node)
                participation (stragglers, step jitter).
    pattern:    host int: index into the schedule's rotations (read by the
                sharded engine's rotation gossip only).

    On the sharded engine the tensors hold this rank's rows: ``w`` its rows
    of W_t, ``active`` and ``local_mask`` its nodes.
    comp_scale: host ``np.float32`` in (0, 1], the share of the codec's
                payload spent this round, or None for the static setting.
    trigger:    host ``np.float32``, the async trigger's threshold this
                round (negative keeps the channel's own), or None.
    """

    w: Optional[torch.Tensor] = None
    active: Optional[torch.Tensor] = None
    local_mask: Optional[torch.Tensor] = None
    pattern: Optional[int] = None
    comp_scale: Optional[Any] = None
    trigger: Optional[Any] = None


def _select_leaf(mask: torch.Tensor, new: Any, old: Any) -> Any:
    """The per-node select over one state value: node-stacked tensors take
    ``new`` on unmasked nodes and ``old`` elsewhere; dataclasses, dicts,
    tuples and packed payloads are walked; ints, None and tensors
    without the node axis keep ``new`` (the step counter is global)."""
    if isinstance(new, torch.Tensor):
        n = mask.shape[0]
        if new.dim() == 0 or new.shape[0] != n:
            return new
        return torch.where(mask.reshape((n,) + (1,) * (new.dim() - 1)), new, old)
    if isinstance(new, Packed):
        return Packed(_select_leaf(mask, new.data, old.data), meta=new.meta)
    if isinstance(new, dict):
        return {k: _select_leaf(mask, v, old[k]) for k, v in new.items()}
    if isinstance(new, tuple):
        return tuple(_select_leaf(mask, a, b) for a, b in zip(new, old))
    if dataclasses.is_dataclass(new) and not isinstance(new, type):
        return dataclasses.replace(new, **{
            f.name: _select_leaf(mask, getattr(new, f.name), getattr(old, f.name))
            for f in dataclasses.fields(new)
        })
    return new


def _select_nodes(mask: Optional[torch.Tensor], new: Any, old: Any) -> Any:
    """Per-node select between two algorithm states.

    ``mask`` is (N,) bool over the leading node axis: node-stacked tensors,
    the channel's wire state included, take ``new`` where the node is
    unmasked and ``old`` elsewhere; values without a node axis (the host
    step counter, the event count, 0-d tensors, None) take ``new``.  With
    an all-true mask every value equals ``new``'s; with no mask this
    returns ``new`` itself.  As in the reference, a non-node tensor whose
    leading dimension happens to equal N would be gated per node: states
    hold no such buffers.
    """
    if mask is None:
        return new
    return _select_leaf(mask, new, old)


class DecentralizedAlgorithm:
    """Base class of the decentralized methods.

    Subclasses are frozen dataclasses of hyperparameters implementing
    ``init`` / ``local_update`` / ``comm_update`` as functions of the state;
    ``comm`` declares the communication schedule.  The ``compression``,
    ``channel`` and ``overlap`` fields of an instance rebuild its ``comm``
    spec, which is all the executor looks at.
    """

    comm: CommSpec = CommSpec()
    compression: Any = None
    channel: Any = None
    overlap: bool = False
    #: the state field that estimates the global gradient direction, read
    #: by the scenario engine's tracking-error stream; None where no buffer
    #: is gradient-scale (momentum sums, displacement trackers)
    tracking_buffer: Optional[str] = None

    def __post_init__(self):
        repl = {}
        if self.compression is not None:
            repl["compression"] = self.compression
        if self.channel is not None:
            repl["channel"] = self.channel
        if self.overlap:
            repl["overlap"] = True
        if repl:
            object.__setattr__(self, "comm", dataclasses.replace(type(self).comm, **repl))

    def init(self, params: Tree, full_grad_fn: Optional[GradFn] = None) -> Any:
        raise NotImplementedError

    def local_update(self, state: Any, grad_fn: GradFn) -> Any:
        raise NotImplementedError(
            f"{type(self).__name__} communicates every step and has no "
            "communication-free local update; drive it via comm_update()"
        )

    def comm_update(
        self,
        state: Any,
        mix_fn: MixFn,
        grad_fn: Optional[GradFn] = None,
        reset_grad_fn: Optional[GradFn] = None,
    ) -> Any:
        raise NotImplementedError


def make_round_step(
    algorithm: DecentralizedAlgorithm,
    mix_fn: MixFn,
    grad_of_batch: Callable[[Tree, Any], Tree],
    full_grad_fn: Optional[GradFn] = None,
    comm_seed_fn: Optional[SeedFn] = None,
    *,
    comm_grad_of_batch: Optional[Callable[[Tree, Any], Tree]] = None,
    scheduled: bool = False,
    gate_local: bool = True,
    gate_active: bool = True,
    compressed_combine=None,
    transport_hooks: Optional[dict] = None,
):
    """The round executor.

    Returns ``(round_step, round_len)``; ``round_step(state, batches)``
    advances one communication round, where ``batches`` holds one minibatch
    per iteration of the round: the first ``round_len - 1`` feed the local
    updates (the reference's ``lax.scan``, here a Python loop) and the last
    one closes the round with ``comm_update``.  Cadence, round length and
    the reset gradient come from the algorithm's :class:`CommSpec`.

    When the spec resolves to an active channel, every gossip inside
    ``comm_update`` goes through a fresh :class:`ChannelSession`, which reads
    and writes the wire state in ``state.comp`` and takes its codec seeds
    from ``comm_seed_fn(event, buffer, leaf)``.  With no channel the
    executor calls ``comm_update`` with ``mix_fn`` itself.

    With ``scheduled=True`` the executor takes the scenario engine's round
    context: ``round_step(state, batches, ctx)`` with ``ctx`` a
    :class:`RoundCtx`, and ``mix_fn`` takes ``(tree, ctx)``.  A node masked
    in ``ctx.local_mask`` skips that local update, and a node inactive in
    ``ctx.active`` keeps its whole state through the round's communication
    step, wire state included.  ``gate_local`` / ``gate_active`` (the
    scenario's ``needs_local_gate`` / ``needs_active_gate``) leave the
    selects out where no fault can mask a node, so a fault-free scenario
    runs exactly the static executor's operations.

    ``comm_grad_of_batch`` replaces ``grad_of_batch`` for the communication
    step only (the sharded engine's, which records the metrics loss there).
    ``compressed_combine`` is a ``(payload, decoded, ctx) -> mixed`` payload
    transport (the sharded engine's ``rotation_combine`` /
    ``allgather_combine``), and ``transport_hooks`` the engine's wire hooks
    for the difference channels (``neighbor``, ``gather_payload``,
    ``pin_replicated``, ``run_local``, ``pin_node``); see
    ``repro_torch.compression.gossip``.  The three are keyword-only:
    ``comm_seed_fn`` holds the fifth place, where the reference has
    ``comm_grad_of_batch``.

    The round is the composition of two phases, ``round_step.phases =
    (local_phase, comm_phase)``: ``local_phase(state, micro)`` runs the
    ``round_len - 1`` local updates on the minibatches ``micro`` and
    ``comm_phase(state, last)`` the communication step; scheduled, both take
    the round's ``ctx`` as a third argument.  The Simulator's telemetry spans
    call them one by one; ``round_step`` runs the same operations in the
    same order.
    """
    spec = algorithm.comm
    round_len = spec.round_len(getattr(algorithm, "tau", 1))
    comm_gb = comm_grad_of_batch or grad_of_batch
    channel = spec.resolved_channel()
    hooks = dict(transport_hooks or {})
    if channel is not None and comm_seed_fn is None:
        raise ValueError(
            f"{type(algorithm).__name__} gossips through {channel.tag}, which "
            "needs comm_seed_fn(event, buffer, leaf) for its codec seeds"
        )

    def _reset_fn(gf):
        if spec.reset == "full" and full_grad_fn is not None:
            return full_grad_fn
        if spec.reset in ("full", "minibatch"):
            return gf
        return None

    def _comm(state, gf, ctx=None):
        if channel is None:
            mfn = (lambda tree: mix_fn(tree, ctx)) if scheduled else mix_fn
            return algorithm.comm_update(state, mfn, gf, _reset_fn(gf))
        chan_state = getattr(state, "comp", None)
        if chan_state is None:
            raise ValueError(
                f"{type(algorithm).__name__} declares a gossip channel but the "
                "state carries no ChannelState; initialize it via "
                "repro_torch.compression.attach_channel_state(algorithm, state)"
            )
        session = ChannelSession(
            channel, len(spec.buffers), chan_state,
            Transport(mix_fn, scheduled=scheduled, payload_combine=compressed_combine, **hooks),
            comm_seed_fn,
        )
        new = algorithm.comm_update(
            state, lambda tree: session.mix(tree, ctx), gf, _reset_fn(gf)
        )
        return dataclasses.replace(new, comp=session.final_state())

    def _check(batches):
        if len(batches) != round_len:
            raise ValueError(f"expected {round_len} batches, got {len(batches)}")

    if not scheduled:

        def local_phase(state, micro: Sequence):
            for mb in micro:
                state = algorithm.local_update(state, lambda p, mb=mb: grad_of_batch(p, mb))
            return state

        def comm_phase(state, last):
            return _comm(state, lambda p: comm_gb(p, last))

        def round_step(state, batches: Sequence):
            _check(batches)
            state = local_phase(state, batches[: round_len - 1])
            return comm_phase(state, batches[round_len - 1])

        round_step.phases = (local_phase, comm_phase)
        return round_step, round_len

    def local_phase_sched(state, micro: Sequence, ctx: RoundCtx):
        masks = ctx.local_mask if gate_local and ctx.local_mask is not None else None
        for j, mb in enumerate(micro):
            new = algorithm.local_update(state, lambda p, mb=mb: grad_of_batch(p, mb))
            if masks is not None:
                # local updates never touch the channel wire: it passes
                # through, and only the algorithm's own buffers are gated
                comp = getattr(new, "comp", None)
                if comp is not None:
                    new = dataclasses.replace(_select_nodes(
                        masks[j], dataclasses.replace(new, comp=None),
                        dataclasses.replace(state, comp=None)), comp=comp)
                else:
                    new = _select_nodes(masks[j], new, state)
            state = new
        return state

    def comm_phase_sched(state, last, ctx: RoundCtx):
        new = _comm(state, lambda p: comm_gb(p, last), ctx)
        mask = ctx.active if gate_active else None
        gated = _select_nodes(mask, new, state)
        run_local = hooks.get("run_local")
        if mask is not None and run_local is not None and getattr(new, "comp", None) is not None:
            # the compressed allgather's wire holds all N rows on every rank
            # (run_local is installed for that mode only): gate it there,
            # with the mask gathered to all N nodes
            gated = dataclasses.replace(gated, comp=run_local(_select_nodes)(
                mask, new.comp, state.comp))
        return gated

    def round_step_scheduled(state, batches: Sequence, ctx: RoundCtx):
        _check(batches)
        state = local_phase_sched(state, batches[: round_len - 1], ctx)
        return comm_phase_sched(state, batches[round_len - 1], ctx)

    round_step_scheduled.phases = (local_phase_sched, comm_phase_sched)
    return round_step_scheduled, round_len
