"""Topology schedules: the per-round mixing matrix W_t of a scenario.

A schedule is the *time-varying* generalization of ``repro_torch.core.Topology``:
it emits one symmetric doubly-stochastic mixing matrix per communication
round (Assumption 5 holds per-round whenever the round's graph is connected;
for one-peer schedules only the *union* graph over a window is connected,
which is exactly the regime analyzed by gradient tracking on time-varying
graphs — Liu et al., arXiv:2301.01313).

Shift-structured schedules additionally expose a static tuple of
:class:`~repro_torch.core.mixing.Rotation` objects plus a per-round pattern
index, which the sharded engine (``launch/distributed.py``) turns into
neighbour send / recv rotations instead of dense gossip (the dense engine
reads only W_t).

A copy of ``repro.scenarios.schedules`` (numpy only).

Registry: ``TOPOLOGY_SCHEDULES`` maps names to ``factory(n_nodes, **kw)``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ..core.mixing import Rotation
from ..core.topology import Topology, metropolis_hastings, ring, torus

__all__ = [
    "TopologySchedule",
    "StaticSchedule",
    "OnePeerRandom",
    "ExponentialSchedule",
    "PeriodicSwitch",
    "TOPOLOGY_SCHEDULES",
    "make_topology_schedule",
    "torus_dims",
    "RoundSchedule",
    "make_round_schedule",
]


def torus_dims(n: int) -> Tuple[int, int]:
    """Most-square (rows, cols) factorization of n (rows=1 degenerates to a ring)."""
    rows = 1
    for d in range(int(np.sqrt(n)), 0, -1):
        if n % d == 0:
            rows = d
            break
    return rows, n // rows


class TopologySchedule:
    """Base: a deterministic-given-seed sequence of mixing matrices.

    Subclasses implement ``w_at(r, rng)`` returning the (N, N) float64 mixing
    matrix of round ``r``; randomized schedules draw from ``rng`` (consumed
    in round order, so the sequence is reproducible from the scenario seed).
    ``rotations()``/``pattern_at(r)`` are non-None only for shift-structured
    schedules (every round's graph is a union of cyclic shifts).
    """

    name: str = "base"
    n: int = 0

    def w_at(self, r: int, rng: np.random.Generator) -> np.ndarray:
        raise NotImplementedError

    def rotations(self) -> Optional[Tuple[Rotation, ...]]:
        return None

    def pattern_at(self, r: int) -> int:
        return 0

    def generate(self, n_rounds: int, rng: np.random.Generator):
        """Materialize ``(w, pattern)``: (R, N, N) float32 + (R,) int32."""
        w = np.stack([self.w_at(r, rng) for r in range(n_rounds)]).astype(np.float32)
        pattern = np.array(
            [self.pattern_at(r) for r in range(n_rounds)], dtype=np.int32
        )
        return w, pattern


@dataclasses.dataclass(frozen=True)
class StaticSchedule(TopologySchedule):
    """The degenerate schedule: one fixed topology every round."""

    topology: Topology

    @property
    def name(self) -> str:  # type: ignore[override]
        return f"static_{self.topology.name}"

    @property
    def n(self) -> int:  # type: ignore[override]
        return self.topology.n

    def w_at(self, r: int, rng: np.random.Generator) -> np.ndarray:
        return self.topology.w

    def rotations(self) -> Optional[Tuple[Rotation, ...]]:
        if not self.topology.shifts:
            return None
        return (Rotation.from_topology(self.topology),)


@dataclasses.dataclass(frozen=True)
class OnePeerRandom(TopologySchedule):
    """Randomized one-peer gossip: a fresh random perfect matching per round.

    Each round every node exchanges with exactly one peer (W entries 1/2 on
    the matched pair); with odd N one node idles.  Per-round graphs are
    disconnected (spectral gap 1), but the union mixes — the canonical
    time-varying stress test for dual-slow estimation."""

    n_nodes: int
    name: str = "one_peer_random"

    @property
    def n(self) -> int:  # type: ignore[override]
        return self.n_nodes

    def w_at(self, r: int, rng: np.random.Generator) -> np.ndarray:
        n = self.n_nodes
        perm = rng.permutation(n)
        w = np.eye(n, dtype=np.float64)
        for k in range(0, n - 1, 2):
            i, j = int(perm[k]), int(perm[k + 1])
            w[i, i] = w[j, j] = 0.5
            w[i, j] = w[j, i] = 0.5
        return w


@dataclasses.dataclass(frozen=True)
class ExponentialSchedule(TopologySchedule):
    """Symmetric one-peer-family exponential graph: round r uses stride
    ``2^(r mod ceil(log2 N))`` — node i talks to i ± 2^k (mod N).

    Every round's W is a cyclic two-shift (or one-shift at stride N/2)
    matrix, so the whole schedule is shift-structured: the sharded runtime
    cycles through ``ceil(log2 N)`` collective-permute rotations instead of
    dense gossip."""

    n_nodes: int
    name: str = "exponential"

    @property
    def n(self) -> int:  # type: ignore[override]
        return self.n_nodes

    @property
    def strides(self) -> Tuple[int, ...]:
        n = self.n_nodes
        out, s = [], 1
        while s < n:
            out.append(s)
            s *= 2
        return tuple(out) or (0,)

    def _w_for_stride(self, s: int) -> np.ndarray:
        n = self.n_nodes
        if n == 1 or s % n == 0:
            return np.eye(n, dtype=np.float64)
        adj = np.zeros((n, n), dtype=bool)
        for i in range(n):
            adj[i, (i + s) % n] = True
            adj[i, (i - s) % n] = True
        adj[np.diag_indices(n)] = False
        return metropolis_hastings(adj)

    def w_at(self, r: int, rng: np.random.Generator) -> np.ndarray:
        return self._w_for_stride(self.strides[r % len(self.strides)])

    def pattern_at(self, r: int) -> int:
        return r % len(self.strides)

    def rotations(self) -> Optional[Tuple[Rotation, ...]]:
        n = self.n_nodes
        if n == 1:
            return None
        rots = []
        for s in self.strides:
            w = self._w_for_stride(s)
            if (2 * s) % n == 0:  # +s and -s coincide: a single shift
                rots.append(Rotation(float(w[0, 0]), (s,), (float(w[0, s % n]),)))
            else:
                rots.append(
                    Rotation(
                        float(w[0, 0]),
                        (s, n - s),
                        (float(w[0, s]), float(w[0, n - s])),
                    )
                )
        return tuple(rots)


@dataclasses.dataclass(frozen=True)
class PeriodicSwitch(TopologySchedule):
    """Periodic switching between fixed topologies (e.g. ring <-> torus),
    holding each for ``period`` rounds.  Shift-structured iff every member
    topology is."""

    topologies: Tuple[Topology, ...]
    period: int = 1
    name: str = "periodic_switch"

    def __post_init__(self):
        if len({t.n for t in self.topologies}) != 1:
            raise ValueError("all topologies must share n")
        if self.period < 1:
            raise ValueError("period >= 1")

    @property
    def n(self) -> int:  # type: ignore[override]
        return self.topologies[0].n

    def _idx(self, r: int) -> int:
        return (r // self.period) % len(self.topologies)

    def w_at(self, r: int, rng: np.random.Generator) -> np.ndarray:
        return self.topologies[self._idx(r)].w

    def pattern_at(self, r: int) -> int:
        return self._idx(r)

    def rotations(self) -> Optional[Tuple[Rotation, ...]]:
        if not all(t.shifts for t in self.topologies):
            return None
        return tuple(Rotation.from_topology(t) for t in self.topologies)


def _ring_torus(n: int, period: int = 2) -> PeriodicSwitch:
    rows, cols = torus_dims(n)
    return PeriodicSwitch(
        topologies=(ring(n), torus(rows, cols)), period=period,
        name="ring_torus_switch",
    )


TOPOLOGY_SCHEDULES: Dict[str, Callable[..., TopologySchedule]] = {
    "static_ring": lambda n, **kw: StaticSchedule(ring(n)),
    "static_torus": lambda n, **kw: StaticSchedule(torus(*torus_dims(n))),
    "one_peer_random": lambda n, **kw: OnePeerRandom(n),
    "exponential": lambda n, **kw: ExponentialSchedule(n),
    "ring_torus_switch": lambda n, period=2, **kw: _ring_torus(n, period),
}


def make_topology_schedule(name: str, n_nodes: int, **kwargs) -> TopologySchedule:
    try:
        factory = TOPOLOGY_SCHEDULES[name]
    except KeyError:
        raise ValueError(
            f"unknown topology schedule {name!r}; known: {sorted(TOPOLOGY_SCHEDULES)}"
        )
    return factory(n_nodes, **kwargs)


# --------------------------------------------------------------------------
# per-round scalar knob schedules (adaptive compression, async triggers)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RoundSchedule:
    """A per-round scalar schedule for the channel knobs carried in
    ``RoundCtx`` (``comp_scale``: fraction of the codec's shape-static
    payload to spend; ``trigger``: async event threshold).

    kind:  "constant" (always ``start``), "linear" (``start`` -> ``end``
           over the run), or "step" (``start`` for ``hold`` rounds, then
           ``end``).
    hold:  warmup rounds pinned at ``start`` before interpolation begins —
           the "warmup dense -> compress harder" shape is
           ``RoundSchedule("linear", 1.0, 0.1, hold=8)``.
    """

    kind: str = "constant"
    start: float = 1.0
    end: float = 1.0
    hold: int = 0

    def __post_init__(self):
        if self.kind not in ("constant", "linear", "step"):
            raise ValueError(
                f"RoundSchedule kind {self.kind!r} not in "
                "('constant', 'linear', 'step')"
            )
        if self.hold < 0:
            raise ValueError(f"hold must be >= 0, got {self.hold}")

    def values(self, n_rounds: int) -> np.ndarray:
        """(R,) float32 materialized knob values."""
        r = np.arange(n_rounds, dtype=np.float64)
        if self.kind == "constant":
            v = np.full(n_rounds, self.start)
        elif self.kind == "step":
            v = np.where(r < self.hold, self.start, self.end)
        else:  # linear, after the hold prefix
            span = max(n_rounds - 1 - self.hold, 1)
            t = np.clip((r - self.hold) / span, 0.0, 1.0)
            v = self.start + (self.end - self.start) * t
        return v.astype(np.float32)


def make_round_schedule(spec) -> RoundSchedule:
    """Resolve a knob-schedule spec: a ready :class:`RoundSchedule`, a bare
    float (constant), or a ``(kind, start, end[, hold])`` tuple."""
    if isinstance(spec, RoundSchedule):
        return spec
    if isinstance(spec, (int, float)):
        return RoundSchedule("constant", float(spec), float(spec))
    if isinstance(spec, (tuple, list)) and len(spec) in (3, 4):
        kind, start, end = spec[0], float(spec[1]), float(spec[2])
        hold = int(spec[3]) if len(spec) == 4 else 0
        return RoundSchedule(str(kind), start, end, hold)
    raise ValueError(
        f"cannot build a RoundSchedule from {spec!r}; pass a RoundSchedule, "
        "a float, or a (kind, start, end[, hold]) tuple"
    )
