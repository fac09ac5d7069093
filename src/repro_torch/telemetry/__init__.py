"""Unified telemetry: one registry, phase spans, run-stamped exporters.

Counterpart of ``repro.telemetry``; it exports the same names.

    from repro_torch.telemetry import Telemetry, span, profile_trace

    hub = Telemetry(config={"algorithm": "dse_mvr", "tau": 4})
    sim = Simulator(alg, topo, loss, data, batch_size=8, telemetry=hub)
    out = sim.run(params, num_steps=128, eval_every=32)
    hub.export_jsonl("run.jsonl")          # spans + streams + link bytes
    print(hub.prometheus())                # text exposition

See ``registry.py`` (the hub + typed stream registry), ``spans.py``
(fenced phase timers, ``torch.profiler`` trace bracketing), ``export.py``
(JSONL sink, Prometheus text, run metadata), ``trace.py`` (cross-process
causal tracing -> Chrome trace-event / Perfetto JSON), ``diagnostics.py``
(online convergence diagnostics + anomaly events) and ``http.py`` (the
coordinator's live /metrics /healthz /trace fleet-health plane).
"""
from .registry import (
    RUNTIME_STREAM_FIELDS,
    SERVING_STREAM_FIELDS,
    STREAM_AXES,
    STREAM_KINDS,
    TRAINING_STREAM_FIELDS,
    StreamSpec,
    Telemetry,
    register_runtime_streams,
    register_training_streams,
)
from .export import (
    JsonlWriter,
    RecordCursor,
    config_hash,
    prometheus_text,
    run_metadata,
    write_jsonl,
)
from .spans import fence, profile_trace, span
from .trace import (
    TraceRecorder,
    new_run_id,
    round_trace_id,
    trace_events,
    trace_index,
    write_chrome_trace,
)
from .diagnostics import DiagnosticsMonitor, OnlineStat
from .http import FleetServer

__all__ = [
    "Telemetry",
    "StreamSpec",
    "STREAM_KINDS",
    "STREAM_AXES",
    "TRAINING_STREAM_FIELDS",
    "SERVING_STREAM_FIELDS",
    "RUNTIME_STREAM_FIELDS",
    "register_training_streams",
    "register_runtime_streams",
    "run_metadata",
    "config_hash",
    "write_jsonl",
    "prometheus_text",
    "RecordCursor",
    "JsonlWriter",
    "span",
    "profile_trace",
    "fence",
    "TraceRecorder",
    "new_run_id",
    "round_trace_id",
    "trace_events",
    "trace_index",
    "write_chrome_trace",
    "DiagnosticsMonitor",
    "OnlineStat",
    "FleetServer",
]
