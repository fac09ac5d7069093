"""Scenario engine of the port: time-varying topologies, node faults,
client jitter and per-round codec knobs.

Counterpart of ``repro.scenarios``, with the same public names.  Three
orthogonal axes compose a declarative :class:`Scenario`:

  * **topology schedules** (``schedules``): per-round mixing matrices W_t
    (static graphs, randomized one-peer gossip, exponential strides,
    periodic ring <-> torus switching);
  * **fault models** (``faults``): stragglers (skipped local steps), node
    dropout (self-loop renormalized W_t) and link drops;
  * **client heterogeneity** (``heterogeneity``): per-node batch-size and
    local-step jitter.

``Scenario.materialize`` emits the per-round :class:`Schedule` arrays (numpy,
the reference's from the same seed) that ``repro_torch.core.Simulator``
runs through its scheduled executor, and ``metrics`` computes the per-round
streams (consensus distance, tracking error, effective spectral gap, ...) on
the device.  ``SCENARIOS`` is the preset registry.

    sim = Simulator(alg, None, loss_fn, data, b, scenario=make_scenario("dropout_ring"))
    out = sim.run(params, 200, eval_every=200)   # out["streams"], out["schedule"]

``schedules``, ``faults``, ``heterogeneity`` and ``scenario`` are copies of
the reference's numpy modules; ``metrics`` is written in torch.
"""
from .schedules import (
    TOPOLOGY_SCHEDULES,
    ExponentialSchedule,
    OnePeerRandom,
    PeriodicSwitch,
    RoundSchedule,
    StaticSchedule,
    TopologySchedule,
    make_round_schedule,
    make_topology_schedule,
    torus_dims,
)
from .faults import (
    FAULT_MODELS,
    Dropout,
    FaultModel,
    LinkDrop,
    RecordedFaults,
    Stragglers,
    make_fault,
    renormalize_dropout,
    renormalize_link_drop,
)
from .heterogeneity import ClientJitter, uniform_profile
from .scenario import SCENARIOS, Scenario, Schedule, make_scenario, register_scenario
from .metrics import (
    STREAM_FIELDS,
    effective_spectral_gap,
    make_stream_fn,
    masked_consensus,
    replica_drift,
    send_rate,
    staleness,
    tracking_error,
)

__all__ = [
    "Scenario", "Schedule", "SCENARIOS", "make_scenario", "register_scenario",
    "TopologySchedule", "StaticSchedule", "OnePeerRandom",
    "ExponentialSchedule", "PeriodicSwitch", "TOPOLOGY_SCHEDULES",
    "make_topology_schedule", "torus_dims",
    "RoundSchedule", "make_round_schedule",
    "FaultModel", "Stragglers", "Dropout", "LinkDrop", "RecordedFaults",
    "FAULT_MODELS",
    "make_fault", "renormalize_dropout", "renormalize_link_drop",
    "ClientJitter", "uniform_profile",
    "STREAM_FIELDS", "make_stream_fn", "masked_consensus", "tracking_error",
    "effective_spectral_gap", "replica_drift", "staleness", "send_rate",
]
