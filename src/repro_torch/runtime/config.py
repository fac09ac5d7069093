"""Runtime configuration: the ONE config object both roles build from.

Counterpart of ``repro.runtime.config``, copied, with one field more,
``device``: the worker processes build their engines there (CUDA unless
the caller asks for the CPU), and it travels in WELCOME with the rest.
The reference's per-worker device mesh (``jax_distributed``,
``host_devices``) needs more than one card a worker, ROADMAP queue 1 item 8
(b): asking for it raises ``NotImplementedError``.

The coordinator materializes schedules and the workers build engines from the
same ``RuntimeConfig`` — a worker never receives arrays it could derive, it
receives this config in the WELCOME message and derives them (data, model
init, base topology) deterministically from the seeds inside.  That is what
makes the bit-identity guarantee auditable: the only run state ever shipped
over the wire is state the receiving process could not recompute (gathered
rows, the canonical resync bundle).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np

__all__ = ["RuntimeConfig", "owned_nodes"]


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Everything a worker needs to rebuild the run from scratch.

    problem:    name in ``repro_torch.runtime.problems.PROBLEMS`` (dataset
                + model + loss, all derived from ``seed``).
    algorithm:  name in ``repro_torch.core.ALGORITHMS``.
    hyper:      kwargs for ``repro_torch.core.make_algorithm`` (lr, tau,
                alpha, channel, compression, use_fused, ...).  Must be
                picklable.
    topology:   base topology-schedule name (``repro_torch.scenarios``); the
                coordinator layers LIVE membership onto it per round — the
                base scenario itself is fault-free so the schedule rng
                consumption matches a simulated replay exactly.
    n_nodes:    logical nodes, partitioned contiguously over workers
                (:func:`owned_nodes`); n_workers == n_nodes gives one node
                per process.
    host_devices: devices per worker; only 1 (a worker's device mesh is
                ROADMAP queue 1 item 8 (b)).
    jax_distributed: the reference's global device mesh across the group;
                only False (ROADMAP queue 1 item 8 (b)).
    packed_transport: "auto" rides the packed (wire-true) round protocol
                whenever the algorithm qualifies (every gossiped buffer on
                an overlap choco-family channel — see
                ``repro_torch.runtime.engine.packed_transport``): the ROUND message
                broadcasts the canonical encoded payload, workers return
                packed owned payload rows, and the dense contrib/gather
                exchange disappears.  "off" forces the dense protocol.
    snapshot_every: packed-mode cadence (in rounds) of full-state DONEs —
                the rounds whose canonical state feeds the resync store and
                consensus diagnostics.  1 (default) keeps a fresh canonical
                every round (dense-mode semantics for dead-node freezing);
                larger values shrink uplink bytes further, at the cost of
                dead workers' node rows freezing at the LAST SNAPSHOT
                rather than the death round.  The final round is always a
                snapshot.  Ignored by the dense protocol.
    device:     where every worker builds its engine: "cuda" (the default;
                each worker process makes its own CUDA context) or "cpu".
    """

    problem: str = "mlp_blobs"
    algorithm: str = "dse_mvr"
    hyper: Tuple[Tuple[str, Any], ...] = (("lr", 0.05), ("tau", 4), ("alpha", 0.1))
    topology: str = "static_ring"
    n_nodes: int = 8
    n_rounds: int = 8
    batch_size: int = 8
    seed: int = 0
    heartbeat_interval_s: float = 0.25
    heartbeat_timeout_s: float = 3.0
    host_devices: int = 1
    jax_distributed: bool = False
    jax_coordinator_port: int = 0   # 0 = coordinator picks a free port
    packed_transport: str = "auto"  # "auto" | "off"
    snapshot_every: int = 1
    device: str = "cuda"

    def __post_init__(self):
        if self.jax_distributed or self.host_devices != 1:
            raise NotImplementedError(
                "a worker's device mesh (jax_distributed=True, host_devices != 1) needs "
                "more than one card a worker, which repro_torch does not support yet "
                "(ROADMAP queue 1 item 8 (b))")

    @property
    def hyperparams(self) -> Dict[str, Any]:
        return dict(self.hyper)

    def with_(self, **overrides) -> "RuntimeConfig":
        if "hyper" in overrides and isinstance(overrides["hyper"], dict):
            overrides["hyper"] = tuple(sorted(overrides["hyper"].items()))
        return dataclasses.replace(self, **overrides)

    def to_config(self) -> Dict[str, Any]:
        """JSON-able description (telemetry run stamps, bench artifacts)."""
        return dataclasses.asdict(self)


def owned_nodes(n_nodes: int, n_workers: int, worker_id: int) -> np.ndarray:
    """Contiguous node block owned by ``worker_id`` (deterministic, total).

    Every node has exactly one owner; owners hold the node's data shard and
    are authoritative for its state rows in every gather."""
    if not 0 < n_workers <= n_nodes:
        raise ValueError(f"need 1 <= n_workers ({n_workers}) <= n_nodes ({n_nodes})")
    if not 0 <= worker_id < n_workers:
        raise ValueError(f"worker_id {worker_id} out of range for {n_workers} workers")
    return np.array_split(np.arange(n_nodes), n_workers)[worker_id]
