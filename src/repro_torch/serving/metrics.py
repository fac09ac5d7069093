"""Serving-plane metrics streams, recorded through the telemetry hub.

Counterpart of ``repro.serving.metrics``, copied (numpy over the hub).  The
training engines emit ``staleness`` / ``send_rate`` streams from the async
channel's wire state (``repro_torch.scenarios.metrics``); the serving plane
reuses those semantics over the replica-stacked snapshot state and adds the
two request-facing streams the SLO story needs:

  * ``staleness``        -- mean per-replica snapshot age at each publish
                            (same definition as the training stream, replica
                            axis instead of node axis).
  * ``snapshot_age``     -- MAX per-replica age at each publish: the
                            SLO-facing stream (the SLO holds iff this stays
                            strictly below every replica's bound).
  * ``send_rate``        -- fraction of replicas refreshed per publish
                            (bytes-for-freshness: bound b => rate ~ 1/b).
  * ``published_kbytes`` -- analytic wire kbytes the publish moved.
  * ``requests_per_sec`` -- completed requests per wall-clock second,
                            sampled per request-driver run.

``ServingMetrics`` is a host-side recorder over a
:class:`repro_torch.telemetry.Telemetry` hub: every sample lands in
registered ``serving/*`` streams (gauges, a kbyte counter, a per-replica age
vector), so serving reports through the same registry as training, and
:meth:`prometheus` renders the SLO / staleness / requests-per-sec gauges as
a Prometheus text exposition stamped with run metadata.  The stream docs
are the reference's word for word (the registry is shared).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..telemetry import SERVING_STREAM_FIELDS, StreamSpec, Telemetry

__all__ = ["SERVING_STREAM_FIELDS", "ServingMetrics"]

#: per-publish scalar gauges mirrored 1:1 into ``serving/<name>`` streams
_PUBLISH_FIELDS = ("staleness", "snapshot_age", "send_rate")


class ServingMetrics:
    """Per-publish / per-load-run stream recorder over a telemetry hub.

    ``telemetry`` — attach an existing hub (so a co-trained Simulator and
    its serving plane share one registry/exporter); by default each recorder
    owns a private hub (spans off — serving timing is the request driver's
    concern).
    """

    def __init__(self, bounds, telemetry: Optional[Telemetry] = None):
        self.bounds = tuple(int(b) for b in bounds)
        if telemetry is None:
            telemetry = Telemetry(
                config={"serving_bounds": self.bounds}, spans=False
            )
        self.telemetry = telemetry
        for f in _PUBLISH_FIELDS:
            telemetry.register_stream(StreamSpec(
                f"serving/{f}", kind="gauge",
                doc=f"serving-plane per-publish {f} (repro.serving.metrics)",
            ))
        telemetry.register_stream(StreamSpec(
            "serving/published_kbytes", kind="counter", unit="kB",
            doc="analytic wire kbytes published to the replica set",
        ))
        telemetry.register_stream(StreamSpec(
            "serving/replica_age", kind="gauge", axis="replica",
            doc="per-replica snapshot age at each publish",
        ))
        telemetry.register_stream(StreamSpec(
            "serving/requests_per_sec", kind="gauge",
            doc="completed requests per second, per load-test run",
        ))
        telemetry.register_stream(StreamSpec(
            "serving/tokens_per_sec", kind="gauge",
            doc="generated tokens per second, per load-test run",
        ))
        self._publishes = 0
        self._runs = 0

    # -- publish side -------------------------------------------------------
    def record_publish(self, info) -> None:
        """Consume one :meth:`SnapshotPublisher.publish` info dict."""
        tel = self.telemetry
        age = np.asarray(info["age"])
        sent = np.asarray(info["sent"])
        p = self._publishes
        tel.record("serving/staleness", float(age.mean()), step=p)
        tel.record("serving/snapshot_age", float(age.max()), step=p)
        tel.record("serving/send_rate", float(sent.mean()), step=p)
        tel.record("serving/published_kbytes",
                   float(np.asarray(info["bytes"]).sum()) / 1e3, step=p)
        tel.record("serving/replica_age", age.astype(np.float64), step=p)
        self._publishes += 1

    # -- request side -------------------------------------------------------
    def record_requests(self, completed: int, tokens: int, elapsed_s: float) -> None:
        tel = self.telemetry
        r = self._runs
        tel.record("serving/requests_per_sec",
                   completed / max(elapsed_s, 1e-9), step=r)
        tel.record("serving/tokens_per_sec",
                   tokens / max(elapsed_s, 1e-9), step=r)
        self._runs += 1

    # -- views --------------------------------------------------------------
    def streams(self) -> Dict[str, np.ndarray]:
        """Dense per-publish streams (shape (P,) each) plus the per-run
        ``requests_per_sec`` samples."""
        tel = self.telemetry
        out = {}
        for f in _PUBLISH_FIELDS + ("published_kbytes", "requests_per_sec"):
            _, vals = tel.series(f"serving/{f}")
            out[f] = np.asarray(vals, np.float64)
        return out

    def max_age(self) -> np.ndarray:
        """Per-replica max observed age over all publishes (R,)."""
        _, ages = self.telemetry.series("serving/replica_age")
        if len(ages) == 0:
            return np.zeros((len(self.bounds),), np.int64)
        return np.asarray(ages).max(axis=0).astype(np.int64)

    def slo_report(self) -> List[Dict[str, float]]:
        """Per-replica SLO verdict: age must stay STRICTLY below the bound."""
        worst = self.max_age()
        return [
            {"replica": r, "bound": b, "max_age": int(worst[r]), "ok": bool(worst[r] < b)}
            for r, b in enumerate(self.bounds)
        ]

    def slo_ok(self) -> bool:
        return all(row["ok"] for row in self.slo_report())

    def summary(self) -> Dict[str, float]:
        s = self.streams()
        def _m(x):
            return float(np.mean(x)) if len(x) else float("nan")
        return {
            "publishes": self._publishes,
            "staleness": _m(s["staleness"]),
            "snapshot_age_max": float(s["snapshot_age"].max()) if len(s["snapshot_age"]) else float("nan"),
            "send_rate": _m(s["send_rate"]),
            "published_kbytes": float(s["published_kbytes"].sum()) if len(s["published_kbytes"]) else 0.0,
            "requests_per_sec": _m(s["requests_per_sec"]),
            "slo_ok": self.slo_ok(),
        }

    def prometheus(self, prefix: str = "repro") -> str:
        """Prometheus text exposition of the serving gauges (latest values),
        the cumulative publish-kbyte counter, per-replica SLO verdicts and
        the run-metadata info stamp."""
        tel = self.telemetry
        tel.gauge("serving/slo_ok", 1.0 if self.slo_ok() else 0.0)
        worst = self.max_age().astype(np.float64)
        if "serving/max_age" not in tel.streams:
            tel.register_stream(StreamSpec(
                "serving/max_age", kind="gauge", axis="replica",
                doc="per-replica max observed snapshot age (SLO: < bound)",
            ))
        tel.record("serving/max_age", worst)
        return tel.prometheus(prefix)
