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
per-buffer channel mappings and comm/compute overlap, on the dense engine.
The scenario engine's scheduled executor is ROADMAP queue 1 item 4.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

from ..compression.base import make_compressor
from ..compression.channels import (
    ChannelSession, ChocoChannel, PerBufferChannel, SeedFn, SyncChannel, Transport,
    make_channel,
)

Tree = Any
GradFn = Callable[[Tree], Tree]       # params -> grads (batch closed over)
MixFn = Callable[[Tree], Tree]        # gossip: tree -> mixed tree

__all__ = ["CommSpec", "DecentralizedAlgorithm", "make_round_step"]

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
):
    """The round executor (the reference's static branch).

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
    """
    spec = algorithm.comm
    round_len = spec.round_len(getattr(algorithm, "tau", 1))
    channel = spec.resolved_channel()
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

    def _comm(state, gf):
        if channel is None:
            return algorithm.comm_update(state, mix_fn, gf, _reset_fn(gf))
        chan_state = getattr(state, "comp", None)
        if chan_state is None:
            raise ValueError(
                f"{type(algorithm).__name__} declares a gossip channel but the "
                "state carries no ChannelState; initialize it via "
                "repro_torch.compression.attach_channel_state(algorithm, state)"
            )
        session = ChannelSession(
            channel, len(spec.buffers), chan_state, Transport(mix_fn), comm_seed_fn
        )
        new = algorithm.comm_update(state, session.mix, gf, _reset_fn(gf))
        return dataclasses.replace(new, comp=session.final_state())

    def round_step(state, batches: Sequence):
        if len(batches) != round_len:
            raise ValueError(f"expected {round_len} batches, got {len(batches)}")
        for mb in batches[: round_len - 1]:
            state = algorithm.local_update(state, lambda p, mb=mb: grad_of_batch(p, mb))
        last = batches[round_len - 1]
        return _comm(state, lambda p: grad_of_batch(p, last))

    return round_step, round_len
