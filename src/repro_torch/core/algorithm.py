"""Algorithm interface of the port: ``DecentralizedAlgorithm`` + ``CommSpec``.

Counterpart of ``repro.core.algorithm``.  Every method factors into

    init(params, full_grad_fn=None)                    -> state
    local_update(state, grad_fn)                       -> state   # no comm
    comm_update(state, mix_fn, grad_fn, reset_grad_fn) -> state   # gossip step

plus a declarative :class:`CommSpec` naming which buffers are gossiped, on
what cadence, and which gradient resets the direction estimate.
:func:`make_round_step` is the one round executor the Simulator drives.

Gossip compression, gossip channels and comm/compute overlap are not ported
yet (ROADMAP queue 1 item 5); asking for them raises.  The scenario
engine's scheduled executor is ROADMAP queue 1 item 4.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

Tree = Any
GradFn = Callable[[Tree], Tree]       # params -> grads (batch closed over)
MixFn = Callable[[Tree], Tree]        # gossip: tree -> mixed tree

__all__ = ["CommSpec", "DecentralizedAlgorithm", "make_round_step"]

CADENCES = ("every_step", "every_tau")
RESETS = ("none", "minibatch", "full")

_NOT_PORTED = (
    "gossip compression, channels and overlap are not ported to repro_torch "
    "yet (ROADMAP queue 1 item 5)"
)


@dataclasses.dataclass(frozen=True)
class CommSpec:
    """Declarative communication schedule of a decentralized algorithm.

    cadence:  "every_step" (gossip every iteration) or "every_tau" (tau-1
              local updates, then one ``comm_update`` closes the round).
    buffers:  names of the param-sized messages gossiped per communication
              event, in the order ``comm_update`` mixes them.
    reset:    the gradient the executor hands ``comm_update`` as
              ``reset_grad_fn``: "full" (full local gradient, the DSE-MVR
              v-reset), "minibatch" (fresh minibatch gradient, DSE-SGD) or
              "none".
    """

    cadence: str = "every_tau"
    buffers: Tuple[str, ...] = ("params",)
    reset: str = "none"

    def __post_init__(self):
        if self.cadence not in CADENCES:
            raise ValueError(f"cadence {self.cadence!r} not in {CADENCES}")
        if self.reset not in RESETS:
            raise ValueError(f"reset {self.reset!r} not in {RESETS}")

    def round_len(self, tau: int) -> int:
        """Steps per communication round (1 for every-step methods)."""
        return 1 if self.cadence == "every_step" else max(int(tau), 1)


class DecentralizedAlgorithm:
    """Base class of the decentralized methods.

    Subclasses are frozen dataclasses of hyperparameters implementing
    ``init`` / ``local_update`` / ``comm_update`` as functions of the state;
    ``comm`` declares the communication schedule.
    """

    comm: CommSpec = CommSpec()
    compression: Any = None
    channel: Any = None
    overlap: bool = False

    def __post_init__(self):
        if self.compression is not None or self.channel is not None or self.overlap:
            raise NotImplementedError(_NOT_PORTED)

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
):
    """The round executor (the reference's static branch).

    Returns ``(round_step, round_len)``; ``round_step(state, batches)``
    advances one communication round, where ``batches`` holds one minibatch
    per iteration of the round: the first ``round_len - 1`` feed the local
    updates (the reference's ``lax.scan``, here a Python loop) and the last
    one closes the round with ``comm_update``.  Cadence, round length and
    the reset gradient come from the algorithm's :class:`CommSpec`.
    """
    spec = algorithm.comm
    round_len = spec.round_len(getattr(algorithm, "tau", 1))

    def _reset_fn(gf):
        if spec.reset == "full" and full_grad_fn is not None:
            return full_grad_fn
        if spec.reset in ("full", "minibatch"):
            return gf
        return None

    def round_step(state, batches: Sequence):
        if len(batches) != round_len:
            raise ValueError(f"expected {round_len} batches, got {len(batches)}")
        for mb in batches[: round_len - 1]:
            state = algorithm.local_update(state, lambda p, mb=mb: grad_of_batch(p, mb))
        last = batches[round_len - 1]
        gf = lambda p: grad_of_batch(p, last)  # noqa: E731
        return algorithm.comm_update(state, mix_fn, gf, _reset_fn(gf))

    return round_step, round_len
