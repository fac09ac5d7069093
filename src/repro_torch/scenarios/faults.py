"""Fault models: stochastic perturbations layered onto a topology schedule.

A copy of ``repro.scenarios.faults`` (numpy only).

Each model rewrites the materialized schedule arrays in round order using the
scenario's seeded rng, so a scenario is fully reproducible from its seed:

  * ``Stragglers``  — per-(local-step, node) skips: the node misses that
    local update but still joins the round's gossip.  W_t untouched, so
    shift-structured schedules KEEP their collective-permute rotations.
  * ``Dropout``     — whole-node round outages: the node freezes (no local
    steps, no gossip) and W_t is renormalized with self-loops — the dropped
    node's row/column become e_i and its off-diagonal mass moves to its
    neighbors' diagonals, so W_t stays symmetric doubly stochastic and the
    active block is itself doubly stochastic.
  * ``LinkDrop``    — per-edge outages: a dropped edge's weight moves to both
    endpoint diagonals (symmetric self-loop renormalization; row/col sums
    preserved exactly).

``Dropout``/``LinkDrop`` change W_t, which invalidates static rotations —
the scenario engine then falls back to dense scheduled gossip.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Type

import numpy as np

__all__ = [
    "FaultModel",
    "Stragglers",
    "Dropout",
    "LinkDrop",
    "RecordedFaults",
    "FAULT_MODELS",
    "make_fault",
    "renormalize_dropout",
    "renormalize_link_drop",
]


def renormalize_dropout(w: np.ndarray, active: np.ndarray) -> np.ndarray:
    """Self-loop renormalization for node dropout.

    For inactive node i: every active neighbor j absorbs w[j, i] into its own
    diagonal, row/col i are zeroed and w[i, i] = 1.  Preserves symmetry and
    double stochasticity; the active principal block is doubly stochastic on
    its own."""
    w = np.array(w, dtype=np.float64, copy=True)
    inactive = np.flatnonzero(~active)
    if inactive.size == 0:
        return w
    for i in inactive:
        w[np.diag_indices_from(w)] += w[:, i] * (np.arange(len(w)) != i)
        w[i, :] = 0.0
        w[:, i] = 0.0
        w[i, i] = 1.0
    return w


def renormalize_link_drop(w: np.ndarray, dropped: np.ndarray) -> np.ndarray:
    """Move each dropped edge's weight onto both endpoint diagonals.

    ``dropped`` is an (N, N) boolean mask over the strict upper triangle
    (symmetrized internally).  Row/col sums are preserved exactly."""
    w = np.array(w, dtype=np.float64, copy=True)
    iu, ju = np.nonzero(np.triu(dropped, k=1))
    for i, j in zip(iu, ju):
        wij = w[i, j]
        if wij == 0.0:
            continue
        w[i, i] += wij
        w[j, j] += wij
        w[i, j] = 0.0
        w[j, i] = 0.0
    return w


class FaultModel:
    """Base: mutates the materialized ``Schedule`` arrays in place.

    The class-level flags tell the engines *statically* which executor gates
    a scenario needs, so fault-free axes pay zero overhead (and the
    degenerate scenario stays bit-identical to the static executor):

      mutates_w    — rewrites W_t (disables rotation gossip);
      gates_local  — can mask per-(local step, node) participation;
      gates_active — can take whole nodes offline for a round.
    """

    name: str = "fault"
    mutates_w: bool = False
    gates_local: bool = False
    gates_active: bool = False

    def apply(self, schedule, rng: np.random.Generator) -> None:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Stragglers(FaultModel):
    """Each (local step, node) is skipped independently with probability p."""

    p: float = 0.2
    name: str = "stragglers"
    mutates_w = False
    gates_local = True

    def apply(self, schedule, rng: np.random.Generator) -> None:
        keep = rng.random(schedule.local_mask.shape) >= self.p
        schedule.local_mask &= keep


@dataclasses.dataclass(frozen=True)
class Dropout(FaultModel):
    """Each node is offline for a whole round independently with probability p."""

    p: float = 0.1
    name: str = "dropout"
    mutates_w = True
    gates_local = True
    gates_active = True

    def apply(self, schedule, rng: np.random.Generator) -> None:
        n_rounds = schedule.w.shape[0]
        for r in range(n_rounds):
            up = rng.random(schedule.active.shape[1]) >= self.p
            schedule.active[r] &= up
            schedule.local_mask[r] &= schedule.active[r][None, :]
            schedule.w[r] = renormalize_dropout(
                schedule.w[r].astype(np.float64), schedule.active[r]
            ).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class LinkDrop(FaultModel):
    """Each edge is down for the round independently with probability p."""

    p: float = 0.1
    name: str = "link_drop"
    mutates_w = True

    def apply(self, schedule, rng: np.random.Generator) -> None:
        n_rounds, n = schedule.w.shape[0], schedule.w.shape[1]
        for r in range(n_rounds):
            dropped = rng.random((n, n)) < self.p
            schedule.w[r] = renormalize_link_drop(
                schedule.w[r].astype(np.float64), dropped
            ).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class RecordedFaults(FaultModel):
    """Replay a RECORDED per-round liveness log — the live-membership
    backend's bridge back into the scheduled engines.

    The elastic runtime (``repro_torch.runtime``) observes actual membership (a
    worker that died, stalled or rejoined) and logs the per-round active
    mask it trained under; replaying that log through this model drives the
    simulator through bit-identical schedules: the renormalization sequence
    below is exactly :class:`Dropout.apply` with the recorded mask in place
    of the sampled one, and no scenario rng is consumed — so a fault-free
    base scenario plus this model materializes the same W_t/mask arrays the
    coordinator issued live.

    ``active_log`` is (n_rounds, n_nodes), stored as nested tuples so the
    spec stays frozen/hashable/serializable like every other fault model.
    """

    active_log: tuple = ()
    name: str = "recorded"
    mutates_w = True
    gates_local = True
    gates_active = True

    def __post_init__(self):
        log = np.asarray(self.active_log, dtype=bool)
        if log.ndim != 2:
            raise ValueError(
                f"active_log must be (n_rounds, n_nodes); got shape {log.shape}"
            )
        object.__setattr__(
            self, "active_log", tuple(tuple(bool(v) for v in row) for row in log)
        )

    def apply(self, schedule, rng: np.random.Generator) -> None:
        log = np.asarray(self.active_log, dtype=bool)
        n_rounds, n = schedule.w.shape[0], schedule.w.shape[1]
        if log.shape != (n_rounds, n):
            raise ValueError(
                f"active_log has shape {log.shape}, schedule needs {(n_rounds, n)}"
            )
        for r in range(n_rounds):
            schedule.active[r] &= log[r]
            schedule.local_mask[r] &= schedule.active[r][None, :]
            schedule.w[r] = renormalize_dropout(
                schedule.w[r].astype(np.float64), schedule.active[r]
            ).astype(np.float32)


FAULT_MODELS: Dict[str, Type[FaultModel]] = {
    "stragglers": Stragglers,
    "dropout": Dropout,
    "link_drop": LinkDrop,
    "recorded": RecordedFaults,
}


def make_fault(name: str, **kwargs) -> FaultModel:
    try:
        cls = FAULT_MODELS[name]
    except KeyError:
        raise ValueError(f"unknown fault model {name!r}; known: {sorted(FAULT_MODELS)}")
    return cls(**kwargs)
