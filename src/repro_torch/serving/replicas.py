"""The serving-side subscriber set: dequantized snapshots + freshness SLO.

Counterpart of ``repro.serving.replicas``.  ``ReplicaSet`` owns one
:class:`~repro_torch.serving.snapshot.SnapshotState` (replica-stacked),
calls :meth:`SnapshotPublisher.publish` once per training round and keeps
the serving metrics streams (:class:`~repro_torch.serving.ServingMetrics`).
Call :meth:`publish` with the node-mean parameters after each round:

    replicas = ReplicaSet(params, codec="qsgd", bounds=(1, 4))
    for round in training:
        state = run_round(state)
        replicas.publish(node_mean(state.params))
    replicas.assert_slo()             # freshness SLO: age_r < bound_r, always
    serve(replicas.params_for(0))     # bound-1 replica: freshest snapshot

A publish runs on the parameters' device and copies only its small info
tensors to the host, in one transfer.  The SLO is structural -- ages are
bounded by the publish algebra -- and ``assert_slo`` re-checks the recorded
stream so a regression in the algebra cannot pass silently.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .metrics import ServingMetrics
from .snapshot import SnapshotPublisher, SnapshotState

Tree = Any

__all__ = ["ReplicaSet"]


def host_info(info) -> dict:
    """A publish's (R,) info tensors as host numpy, in one device copy."""
    rows = torch.stack([info["sent"].to(torch.float32), info["age"].to(torch.float32),
                        info["drift"].to(torch.float32), info["bytes"]]).cpu().numpy()
    return {"sent": rows[0] > 0, "age": rows[1].astype(np.int32), "drift": rows[2],
            "bytes": rows[3]}


class ReplicaSet:
    """A set of inference replicas subscribed to live training.

    params:    the parameter tree being trained (shapes, dtypes and device
               only are used at init -- nothing is served until the first
               publish).
    codec:     snapshot wire codec spec (see :class:`SnapshotPublisher`).
    bounds:    per-replica staleness bounds -- replica r's freshness SLO.
    threshold: relative-drift early-refresh trigger θ.
    publisher: a ready :class:`SnapshotPublisher` (overrides codec/bounds/
               threshold), e.g. one with an injected ``seed_fn``.
    key:       the integer the default codec seeds derive from.
    telemetry: an optional shared ``repro_torch.telemetry.Telemetry`` hub.
    """

    def __init__(
        self,
        params: Tree,
        *,
        codec: Any = None,
        bounds: Tuple[int, ...] = (1,),
        threshold: Optional[float] = None,
        publisher: Optional[SnapshotPublisher] = None,
        key: Optional[int] = None,
        telemetry=None,
    ):
        self.publisher = publisher or SnapshotPublisher(
            codec=codec, bounds=bounds, threshold=threshold
        )
        self.state: SnapshotState = self.publisher.init(params, key=key)
        self.metrics = ServingMetrics(self.publisher.bounds, telemetry=telemetry)
        self._bytes = np.zeros((self.publisher.n_replicas,), np.float64)

    # ------------------------------------------------------------------
    @property
    def bounds(self) -> Tuple[int, ...]:
        return self.publisher.bounds

    @property
    def n_replicas(self) -> int:
        return self.publisher.n_replicas

    def publish(self, live_params: Tree) -> dict:
        """One training-round publish tick; returns the publish info dict
        (host numpy) after folding it into the metrics streams."""
        self.state, info = self.publisher.publish(self.state, live_params)
        info = host_info(info)
        self.metrics.record_publish(info)
        self._bytes += info["bytes"].astype(np.float64)
        return info

    # ------------------------------------------------------------------
    def params_for(self, i: int) -> Tree:
        """The dequantized snapshot replica ``i`` serves right now."""
        return self.publisher.replica_params(self.state, i)

    def served_params(self) -> List[Tree]:
        return [self.params_for(i) for i in range(self.n_replicas)]

    def ages(self) -> np.ndarray:
        return self.state.age.cpu().numpy()

    def link_bytes(self) -> np.ndarray:
        """Cumulative analytic wire bytes per replica link -- the
        bytes-for-freshness axis (bound b costs about 1/b of bound 1)."""
        return self._bytes.copy()

    # ------------------------------------------------------------------
    def slo_report(self) -> List[dict]:
        return self.metrics.slo_report()

    def assert_slo(self) -> None:
        """Raise unless every replica honored its freshness SLO (observed
        snapshot age strictly below the staleness bound at every publish)."""
        report = self.slo_report()
        bad = [row for row in report if not row["ok"]]
        if bad:
            raise AssertionError(f"staleness SLO violated: {bad}")
