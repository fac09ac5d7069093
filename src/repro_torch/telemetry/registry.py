"""The ONE metrics registry: typed streams for training, sweeps and serving.

Counterpart of ``repro.telemetry.registry``, copied (numpy only).  The
:class:`Telemetry` hub puts the scenario engine's per-round streams
(``repro_torch.scenarios.metrics``), the serving plane's recorder
(``repro_torch.serving.metrics.ServingMetrics``) and the fused-op backend's
launch counters (``repro_torch.kernels.api``) behind one ``register_stream``
/ ``record`` / ``collect`` API:

  * a **stream** is a named, typed series -- ``gauge`` (sampled value),
    ``counter`` (monotone accumulation; ``record`` takes increments) or
    ``histogram`` (observations summarized at collect time) -- declared over
    an axis (``scalar``, ``node``, ``replica``) and optionally split by a
    string ``label`` (per-buffer link bytes, per-op kernel launches,
    per-phase span durations);
  * every hub carries immutable **run metadata** (git SHA, torch version,
    device kind, config hash -- see :func:`repro_torch.telemetry.export.
    run_metadata`) stamped onto every exported record;
  * exporters live in ``repro_torch.telemetry.export``: a run-stamped JSONL
    event sink (:meth:`Telemetry.export_jsonl`) and a Prometheus-style text
    exposition (:meth:`Telemetry.prometheus`).

The hub is host-side and append-only: the engines hand it host values they
already hold (a chunk's numpy copy of the streams, analytic byte counts), so
attaching a hub changes no computation on the device.  The stream names and
docs are the reference's word for word, so both packages export the same
registry.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "STREAM_KINDS",
    "STREAM_AXES",
    "StreamSpec",
    "Telemetry",
    "TRAINING_STREAM_FIELDS",
    "SERVING_STREAM_FIELDS",
    "RUNTIME_STREAM_FIELDS",
]

STREAM_KINDS = ("gauge", "counter", "histogram")
STREAM_AXES = ("scalar", "node", "replica")

#: the scenario engine's per-round streams (the functions computing them stay
#: in ``repro_torch.scenarios.metrics``, on the device, but their REGISTRY
#: entries live here, the one place stream names are declared;
#: ``scenarios.metrics.STREAM_FIELDS`` re-exports this tuple).
TRAINING_STREAM_FIELDS = (
    "consensus", "tracking_err", "spectral_gap", "active_nodes",
    "compression_err", "replica_drift", "staleness", "send_rate",
)

#: the serving plane's per-publish / per-load-run streams (recorded by
#: ``repro_torch.serving.metrics.ServingMetrics``, which is backed by a hub).
SERVING_STREAM_FIELDS = (
    "staleness", "snapshot_age", "send_rate", "published_kbytes",
    "requests_per_sec",
)

#: the elastic runtime's membership / liveness / resync streams
#: (``repro_torch.runtime``):
#: coordinator-side membership and round timing, plus the per-worker
#: contribution times streamed over the control channel.
RUNTIME_STREAM_FIELDS = (
    "membership_epoch", "active_workers", "heartbeat_age",
    "round_seconds", "contrib_seconds", "resync_seconds",
)


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Declarative stream registration.

    kind: "gauge" — each record is a sampled value; "counter" — each record
          is an INCREMENT, the hub tracks the monotone total; "histogram" —
          each record is one observation, summarized (count/mean/percentiles)
          at collect time.
    axis: the shape of one sample — "scalar" (a float) or a per-"node" /
          per-"replica" vector (stored as-is; exporters reduce or expand
          per label as appropriate).
    """

    name: str
    kind: str = "gauge"
    axis: str = "scalar"
    unit: str = ""
    doc: str = ""

    def __post_init__(self):
        if self.kind not in STREAM_KINDS:
            raise ValueError(f"stream kind {self.kind!r} not in {STREAM_KINDS}")
        if self.axis not in STREAM_AXES:
            raise ValueError(f"stream axis {self.axis!r} not in {STREAM_AXES}")


# the hub's built-in cross-cutting streams, registered on every hub so the
# span/link/kernel plumbing can record without per-call-site registration.
# Their docs are the reference's (see the module docstring); the port's
# launch count is per launch made (``record_kernel_launches``)
_BUILTIN_STREAMS = (
    StreamSpec("span_seconds", kind="histogram", unit="s",
               doc="fenced host-side phase span durations, labeled by phase"),
    StreamSpec("link_bytes", kind="counter", unit="B",
               doc="cumulative analytic wire bytes per gossip buffer/channel "
                   "(label = buffer/channel-tag), all nodes"),
    StreamSpec("kernel_launches", kind="counter",
               doc="fused-op kernel launches per op (trace-time count from "
                   "repro.kernels.api)"),
)


class Telemetry:
    """The unified telemetry hub.

    config:  optional run configuration (any JSON-able object) hashed into
             the run metadata's ``config_hash``.
    spans:   enable host-side phase-span timing.  With spans on, engines
             that support it (the Simulator, the request driver) wrap each
             phase in a span fenced by a device synchronize, so per-phase
             durations are real; with spans off they run as without a hub
             and the hub only collects streams/counters.
    meta:    override the auto-derived run metadata dict.
    """

    def __init__(self, config: Any = None, *, spans: bool = True,
                 meta: Optional[Dict[str, Any]] = None):
        from .export import run_metadata  # lazy: export imports nothing of ours

        self.meta: Dict[str, Any] = dict(meta) if meta is not None else run_metadata(config)
        self.spans = bool(spans)
        self._specs: Dict[str, StreamSpec] = {}
        # (name, label) -> list of (step, value); counters store increments
        self._series: Dict[Tuple[str, str], List[Tuple[Optional[int], Any]]] = {}
        self._totals: Dict[Tuple[str, str], float] = {}
        self._events: List[Dict[str, Any]] = []
        self._kernel_seen: Dict[str, int] = {}
        for spec in _BUILTIN_STREAMS:
            self.register_stream(spec)

    # -- registry ----------------------------------------------------------
    def register_stream(self, spec_or_name, **kw) -> StreamSpec:
        """Register a stream (idempotent for an identical spec; conflicting
        re-registration is an error — a silently retyped stream would
        corrupt every exporter reading it)."""
        spec = (
            spec_or_name
            if isinstance(spec_or_name, StreamSpec)
            else StreamSpec(spec_or_name, **kw)
        )
        prev = self._specs.get(spec.name)
        if prev is not None and prev != spec:
            raise ValueError(
                f"stream {spec.name!r} already registered as {prev}, "
                f"conflicting re-registration: {spec}"
            )
        self._specs[spec.name] = spec
        return spec

    def spec(self, name: str) -> StreamSpec:
        try:
            return self._specs[name]
        except KeyError:
            raise KeyError(
                f"unknown stream {name!r}; registered: {sorted(self._specs)}"
            ) from None

    @property
    def streams(self) -> Tuple[str, ...]:
        return tuple(sorted(self._specs))

    # -- recording ---------------------------------------------------------
    @staticmethod
    def _value(v):
        arr = np.asarray(v)
        return float(arr) if arr.ndim == 0 else arr.astype(np.float64)

    def record(self, name: str, value, *, step: Optional[int] = None,
               label: str = "") -> None:
        """Record one sample into a REGISTERED stream.  Gauges/histograms
        store the value; counters treat ``value`` as an increment."""
        spec = self.spec(name)
        v = self._value(value)
        key = (name, label)
        self._series.setdefault(key, []).append((step, v))
        if spec.kind == "counter":
            self._totals[key] = self._totals.get(key, 0.0) + float(np.sum(v))

    def gauge(self, name: str, value, *, step: Optional[int] = None,
              label: str = "") -> None:
        """Convenience: record into ``name``, auto-registering it as a
        scalar gauge when unknown (ad-hoc eval metrics)."""
        if name not in self._specs:
            self.register_stream(StreamSpec(name, kind="gauge"))
        self.record(name, value, step=step, label=label)

    def record_many(self, values: Dict[str, Any], *, step: Optional[int] = None,
                    label: str = "") -> None:
        for k, v in values.items():
            self.record(k, v, step=step, label=label)

    def record_event(self, event: Dict[str, Any]) -> None:
        """Append a raw exporter event (span records use this so the JSONL
        stream carries per-round phase durations as first-class events)."""
        self._events.append(dict(event))

    # -- cross-cutting recorders ------------------------------------------
    def record_link_bytes(self, per_round: Dict[str, float], *,
                          rounds: int = 1, factor: float = 1.0,
                          step: Optional[int] = None) -> None:
        """Accumulate per-buffer/channel link-byte counters: ``per_round``
        maps a ``buffer/channel-tag`` label to analytic bytes ONE round puts
        on the wire (all nodes; see ``repro_torch.compression.channels.
        link_bytes_per_round``).  ``factor`` scales event-triggered channels
        by their measured send fraction."""
        for label, per in per_round.items():
            self.record("link_bytes", float(per) * int(rounds) * float(factor),
                        step=step, label=label)

    def record_kernel_launches(self, *, step: Optional[int] = None) -> Dict[str, int]:
        """Fold the fused-op backend's launch counters
        (``repro_torch.kernels.api.launch_counts()``) into the
        ``kernel_launches`` counter stream (one label per op), recording only
        the delta since the last call.  Returns the delta.

        The port counts each launch as it is made, one per eager call of a
        kernel's wrapper (one per dtype bucket per ``tree_apply``); the
        reference counts at trace time.  Per step the unit is the same, so a run's
        totals compare; on the CPU nothing launches and the delta is empty.
        """
        from ..kernels import api  # lazy: keep the hub importable standalone

        counts = api.launch_counts()
        delta = {
            op: n - self._kernel_seen.get(op, 0)
            for op, n in counts.items()
            if n - self._kernel_seen.get(op, 0)
        }
        for op, n in delta.items():
            self.record("kernel_launches", n, step=step, label=op)
        self._kernel_seen = dict(counts)
        return delta

    # -- views -------------------------------------------------------------
    def labels(self, name: str) -> Tuple[str, ...]:
        self.spec(name)
        return tuple(sorted({lb for (n, lb) in self._series if n == name}))

    def series(self, name: str, label: str = "") -> Tuple[np.ndarray, np.ndarray]:
        """(steps, values) of one stream/label; counters give increments."""
        self.spec(name)
        rows = self._series.get((name, label), [])
        steps = np.asarray([-1 if s is None else s for s, _ in rows], np.int64)
        vals = [v for _, v in rows]
        if vals and isinstance(vals[0], np.ndarray):
            return steps, np.stack(vals)
        return steps, np.asarray(vals, np.float64)

    def total(self, name: str, label: str = "") -> float:
        if self.spec(name).kind != "counter":
            raise ValueError(f"stream {name!r} is not a counter")
        return self._totals.get((name, label), 0.0)

    @staticmethod
    def _summarize(values: np.ndarray) -> Dict[str, float]:
        flat = np.asarray(values, np.float64).ravel()
        if flat.size == 0:
            return {"count": 0}
        return {
            "count": int(flat.size),
            "sum": float(flat.sum()),
            "mean": float(flat.mean()),
            "p50": float(np.percentile(flat, 50)),
            "p95": float(np.percentile(flat, 95)),
            "max": float(flat.max()),
        }

    def collect(self) -> Dict[str, Dict[str, Any]]:
        """One structured snapshot of every registered stream: the spec, the
        per-label series, counter totals and histogram summaries."""
        out: Dict[str, Dict[str, Any]] = {}
        for name, spec in sorted(self._specs.items()):
            entry: Dict[str, Any] = {
                "spec": dataclasses.asdict(spec),
                "series": {},
            }
            for label in self.labels(name):
                steps, vals = self.series(name, label)
                series = {"steps": steps.tolist(), "values": vals.tolist()}
                if spec.kind == "counter":
                    series["total"] = self.total(name, label)
                if spec.kind == "histogram":
                    series["summary"] = self._summarize(vals)
                entry["series"][label] = series
            out[name] = entry
        return out

    @property
    def events(self) -> List[Dict[str, Any]]:
        return list(self._events)

    # -- exporters (see repro_torch.telemetry.export) ----------------------------
    def export_jsonl(self, path: str) -> int:
        from .export import write_jsonl

        return write_jsonl(self, path)

    def prometheus(self, prefix: str = "repro") -> str:
        from .export import prometheus_text

        return prometheus_text(self, prefix=prefix)


def _register_fields(hub: Telemetry, fields: Sequence[str], doc: str) -> None:
    for f in fields:
        hub.register_stream(StreamSpec(f, kind="gauge", doc=doc))


def register_training_streams(hub: Telemetry) -> None:
    """Register the scenario engine's per-round stream fields as gauges."""
    _register_fields(hub, TRAINING_STREAM_FIELDS,
                     "per-round on-device training stream "
                     "(repro.scenarios.metrics)")


def register_runtime_streams(hub: Telemetry) -> None:
    """Register the elastic runtime's membership/liveness/resync streams."""
    doc = "elastic-runtime membership/liveness stream (repro.runtime)"
    hub.register_stream(StreamSpec("membership_epoch", kind="gauge", doc=doc))
    hub.register_stream(StreamSpec("active_workers", kind="gauge", doc=doc))
    hub.register_stream(StreamSpec("heartbeat_age", kind="gauge", unit="s",
                                   doc=doc + "; label = worker"))
    hub.register_stream(StreamSpec("round_seconds", kind="histogram", unit="s",
                                   doc="wall time of one elastic round "
                                       "(issue -> all DONEs)"))
    hub.register_stream(StreamSpec("contrib_seconds", kind="histogram", unit="s",
                                   doc="worker-side ROUND -> CONTRIB wall time "
                                       "(includes injected straggler sleep)"))
    hub.register_stream(StreamSpec("resync_seconds", kind="histogram", unit="s",
                                   doc="rejoin resync latency (checkpoint "
                                       "bundle -> RESYNC_OK)"))
    hub.register_stream(StreamSpec("socket_round_bytes", kind="histogram",
                                   unit="B",
                                   doc="measured control-channel bytes (tx+rx, "
                                       "framed) that crossed the coordinator's "
                                       "sockets during one round"))
