"""``Scenario``: declarative composition of topology schedule x faults x
client heterogeneity, with a registry of named presets.

A ``Scenario`` is a *spec* (frozen, engine-agnostic, serializable via
``to_config``); ``materialize(n_nodes, n_rounds, round_len)`` turns it into a
``Schedule`` — the concrete per-round arrays both execution engines scan
over:

    w          (R, N, N) float32   mixing matrix W_t (post-fault)
    active     (R, N)    bool      per-round node liveness (dropout)
    local_mask (R, L, N) bool      per-local-step participation (stragglers /
                                   jitter), L = max(round_len - 1, 1)
    pattern    (R,)      int32     rotation index (shift-structured gossip)

plus host-side derived quantities (per-round effective spectral gaps) for
artifacts.  The same seed always reproduces the same schedule.

A copy of ``repro.scenarios.scenario`` (numpy only): the same presets, the
same arrays from the same seed.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..core.topology import spectral_gap
from .faults import FaultModel, make_fault
from .heterogeneity import ClientJitter
from .schedules import (
    RoundSchedule,
    StaticSchedule,
    TopologySchedule,
    make_round_schedule,
    make_topology_schedule,
)

__all__ = ["Scenario", "Schedule", "SCENARIOS", "register_scenario", "make_scenario"]


@dataclasses.dataclass
class Schedule:
    """Materialized per-round arrays of a scenario (host-side numpy)."""

    w: np.ndarray                      # (R, N, N) float32
    active: np.ndarray                 # (R, N) bool
    local_mask: np.ndarray             # (R, L, N) bool
    pattern: np.ndarray                # (R,) int32
    batch_sizes: Optional[np.ndarray] = None   # (N,) int32 per-node batch
    comp_scale: Optional[np.ndarray] = None    # (R,) float32 channel knob
    trigger: Optional[np.ndarray] = None       # (R,) float32 async trigger

    @property
    def n_rounds(self) -> int:
        return self.w.shape[0]

    @property
    def n_nodes(self) -> int:
        return self.w.shape[1]

    def spectral_gaps(self) -> np.ndarray:
        """Host-side per-round effective gap of the active block (artifacts;
        the engines also stream it on-device)."""
        out = np.empty(self.n_rounds, dtype=np.float64)
        for r in range(self.n_rounds):
            a = self.active[r]
            k = int(a.sum())
            if k <= 1:
                out[r] = 0.0
                continue
            sub = self.w[r][np.ix_(a, a)].astype(np.float64)
            out[r] = spectral_gap(sub)
        return out


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Declarative scenario spec consumable by both execution engines.

    topology:        name in ``TOPOLOGY_SCHEDULES`` (or a ready
                     :class:`TopologySchedule` instance for custom graphs).
    topology_kwargs: extra factory kwargs (e.g. ``period`` for switching).
    faults:          tuple of :class:`FaultModel` instances, applied in order.
    jitter:          client heterogeneity profile (None = uniform clients).
    comp_scale:      per-round adaptive-compression knob (None, a float, a
                     ``(kind, start, end[, hold])`` tuple or a
                     :class:`RoundSchedule`): the fraction of the codec's
                     shape-static payload spent each round — "warmup dense
                     -> compress harder" schedules.  Only read by active
                     gossip channels.
    trigger:         per-round async event-trigger threshold override (same
                     spec forms; < 0 or None keeps the channel's static
                     threshold).
    seed:            all schedule randomness (matchings, faults, jitter)
                     derives from this.
    """

    name: str = "baseline"
    topology: Any = "static_ring"
    topology_kwargs: Tuple[Tuple[str, Any], ...] = ()
    faults: Tuple[FaultModel, ...] = ()
    jitter: Optional[ClientJitter] = None
    comp_scale: Any = None
    trigger: Any = None
    seed: int = 0

    # ------------------------------------------------------------------
    @property
    def mutates_w(self) -> bool:
        """True when any fault rewrites W_t (rotation gossip impossible)."""
        return any(f.mutates_w for f in self.faults)

    @property
    def needs_local_gate(self) -> bool:
        """True when local-step participation can be masked (stragglers,
        dropout, step jitter) — the executor only inserts per-node selects
        into the local scan when this holds, so fault-free scenarios stay
        bit-identical to the static executor."""
        return any(f.gates_local for f in self.faults) or (
            self.jitter is not None and self.jitter.step_skip > 0.0
        )

    @property
    def needs_active_gate(self) -> bool:
        """True when whole nodes can go offline for a round (dropout)."""
        return any(f.gates_active for f in self.faults)

    def warn_if_vacuous(self, round_len: int, runtime_batches: bool = False) -> None:
        """Warn when part of this scenario cannot apply on an engine.

        Local-step-only faults (stragglers / step-skip jitter) are vacuous
        for every-step algorithms (``round_len == 1`` — there are no local
        updates to skip); round-level faults like dropout still apply, so
        the message distinguishes the two.  ``runtime_batches=True`` (the
        sharded runtime, which receives externally built batches) also warns
        when batch-size jitter would be silently ignored — an artifact
        recording the jitter config as applied would otherwise be mislabeled.
        """
        straggler_only = any(
            f.gates_local and not f.gates_active for f in self.faults
        ) or (self.jitter is not None and self.jitter.step_skip > 0.0)
        if round_len == 1 and straggler_only:
            others = self.needs_active_gate or self.mutates_w
            warnings.warn(
                f"scenario {self.name!r}: the algorithm communicates every "
                "step (round_len=1), so straggler/step-jitter faults cannot "
                "apply"
                + (
                    " (round-level faults still do)"
                    if others
                    else " — the scenario degenerates to its fault-free variant"
                ),
                RuntimeWarning,
                stacklevel=3,
            )
        if (
            runtime_batches
            and self.jitter is not None
            and self.jitter.batch_frac_range != (1.0, 1.0)
        ):
            warnings.warn(
                f"scenario {self.name!r}: per-node batch-size jitter is not "
                "applied by the sharded runtime (batches are built by the "
                "caller); only step jitter and faults take effect",
                RuntimeWarning,
                stacklevel=3,
            )

    def topology_schedule(self, n_nodes: int) -> TopologySchedule:
        if isinstance(self.topology, TopologySchedule):
            if self.topology.n != n_nodes:
                raise ValueError(
                    f"scenario topology has n={self.topology.n}, engine has {n_nodes}"
                )
            return self.topology
        return make_topology_schedule(
            self.topology, n_nodes, **dict(self.topology_kwargs)
        )

    def is_degenerate(self) -> bool:
        """Static topology, no faults, uniform clients (the PR-1 baseline)."""
        sched = self.topology
        static = (
            isinstance(sched, str) and sched.startswith("static_")
        ) or isinstance(sched, StaticSchedule)
        no_jitter = self.jitter is None or (
            self.jitter.batch_frac_range == (1.0, 1.0) and self.jitter.step_skip == 0.0
        )
        return static and not self.faults and no_jitter

    # ------------------------------------------------------------------
    def materialize(
        self,
        n_nodes: int,
        n_rounds: int,
        round_len: int,
        batch_size: Optional[int] = None,
    ) -> Schedule:
        rng = np.random.default_rng(self.seed)
        topo = self.topology_schedule(n_nodes)
        w, pattern = topo.generate(n_rounds, rng)
        local_len = max(round_len - 1, 1)
        schedule = Schedule(
            w=w,
            active=np.ones((n_rounds, n_nodes), dtype=bool),
            local_mask=np.ones((n_rounds, local_len, n_nodes), dtype=bool),
            pattern=pattern,
        )
        for fault in self.faults:
            fault.apply(schedule, rng)
        if self.jitter is not None:
            self.jitter.apply_step_jitter(schedule, rng)
            if batch_size is not None:
                schedule.batch_sizes = self.jitter.node_batch_sizes(
                    n_nodes, batch_size, rng
                )
        if self.comp_scale is not None:
            schedule.comp_scale = make_round_schedule(self.comp_scale).values(
                n_rounds
            )
        if self.trigger is not None:
            schedule.trigger = make_round_schedule(self.trigger).values(n_rounds)
        return schedule

    # ------------------------------------------------------------------
    def to_config(self) -> Dict[str, Any]:
        """JSON-serializable description (sweep artifacts)."""
        topo = (
            self.topology
            if isinstance(self.topology, str)
            else getattr(self.topology, "name", type(self.topology).__name__)
        )
        def _sched_cfg(spec):
            if spec is None:
                return None
            return dataclasses.asdict(make_round_schedule(spec))

        return {
            "name": self.name,
            "topology": topo,
            "topology_kwargs": dict(self.topology_kwargs),
            "faults": [
                {"name": f.name, **dataclasses.asdict(f)} for f in self.faults
            ],
            "jitter": dataclasses.asdict(self.jitter) if self.jitter else None,
            "comp_scale": _sched_cfg(self.comp_scale),
            "trigger": _sched_cfg(self.trigger),
            "seed": self.seed,
        }


# --------------------------------------------------------------------------
# registry of named presets
# --------------------------------------------------------------------------
SCENARIOS: Dict[str, Scenario] = {}


def register_scenario(scenario: Scenario) -> Scenario:
    if scenario.name in SCENARIOS:
        raise ValueError(f"scenario {scenario.name!r} already registered")
    SCENARIOS[scenario.name] = scenario
    return scenario


def make_scenario(name: str, **overrides) -> Scenario:
    """Fetch a registered preset, optionally overriding spec fields
    (e.g. ``make_scenario("dropout_ring", seed=3)``)."""
    try:
        base = SCENARIOS[name]
    except KeyError:
        raise ValueError(f"unknown scenario {name!r}; known: {sorted(SCENARIOS)}")
    return dataclasses.replace(base, **overrides) if overrides else base


register_scenario(Scenario(name="baseline", topology="static_ring"))
register_scenario(Scenario(name="torus", topology="static_torus"))
register_scenario(Scenario(name="one_peer", topology="one_peer_random"))
register_scenario(Scenario(name="exponential", topology="exponential"))
register_scenario(
    Scenario(name="ring_torus", topology="ring_torus_switch",
             topology_kwargs=(("period", 2),))
)
register_scenario(
    Scenario(name="straggler_ring", faults=(make_fault("stragglers", p=0.3),))
)
register_scenario(
    Scenario(name="dropout_ring", faults=(make_fault("dropout", p=0.15),))
)
register_scenario(
    Scenario(name="lossy_links", faults=(make_fault("link_drop", p=0.2),))
)
register_scenario(
    Scenario(
        name="hetero_clients",
        jitter=ClientJitter(batch_frac_range=(0.25, 1.0), step_skip=0.1),
    )
)
register_scenario(
    Scenario(
        name="hostile",  # everything at once: the robustness stress preset
        topology="one_peer_random",
        faults=(make_fault("dropout", p=0.1), make_fault("stragglers", p=0.2)),
        jitter=ClientJitter(batch_frac_range=(0.5, 1.0)),
    )
)
register_scenario(
    Scenario(
        # the sweepable adaptive-compression preset: gossip dense while the
        # iterates move fast, then spend a tenth of the payload once the
        # error-feedback / replica machinery has signal to work with
        name="warmup_compress",
        comp_scale=RoundSchedule("linear", 1.0, 0.1, hold=4),
    )
)
register_scenario(
    Scenario(
        # async channels under an unreliable network: lossy links plus a
        # drift trigger that tightens over the run (send less as consensus
        # is approached) — pair with channel="async:<bound>"
        name="async_lossy",
        faults=(make_fault("link_drop", p=0.2),),
        trigger=RoundSchedule("linear", 0.0, 0.05),
    )
)
