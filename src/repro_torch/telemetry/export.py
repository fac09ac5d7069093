"""Run-stamped exporters: JSONL event sink + Prometheus text exposition.

Counterpart of ``repro.telemetry.export``, copied; only
:func:`run_metadata` differs (it stamps the torch version and the CUDA card).
Every exported record carries the hub's run metadata (git SHA, torch version,
device kind, config hash) so any line of any artifact can be traced back to
the exact code + config + hardware that produced it — the property the
serving plane's SLO reports and the sweep grids were missing.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
from typing import Any, Dict, Optional

__all__ = [
    "run_metadata", "config_hash", "write_jsonl", "prometheus_text",
    "RecordCursor", "JsonlWriter",
]

_GIT_SHA: Optional[str] = None


def _git_sha() -> str:
    """Memoized: one subprocess per process, not one per hub — benchmarks
    build many hubs and the runtime stamps every worker's records
    (``benchmarks/common.run_stamp`` is the same cached value)."""
    global _GIT_SHA
    if _GIT_SHA is None:
        try:
            out = subprocess.run(
                ["git", "rev-parse", "HEAD"],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                capture_output=True, text=True, timeout=5,
            )
            sha = out.stdout.strip()
            _GIT_SHA = sha if out.returncode == 0 and sha else "unknown"
        except (OSError, subprocess.SubprocessError):
            _GIT_SHA = "unknown"
    return _GIT_SHA


def config_hash(config: Any) -> str:
    """Stable short hash of any JSON-able config (non-JSON-able values fall
    back to ``repr`` so dataclasses/argparse namespaces hash too)."""
    blob = json.dumps(config, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def run_metadata(config: Any = None, process: Optional[str] = None) -> Dict[str, str]:
    """The stamp on every exported record: where (device + pid), what (git
    SHA, torch version) and with which knobs (config hash) this run happened.
    ``device_kind`` is ``cuda:<card name>`` where a CUDA card is present and
    ``cpu`` otherwise (asking never initialises CUDA on a host without one).
    ``process`` names the role in a multi-process run (``"coordinator"``,
    ``"worker:3"``) so records merged into one stream stay attributable."""
    import torch

    kind = f"cuda:{torch.cuda.get_device_name()}" if torch.cuda.is_available() else "cpu"
    meta = {
        "git_sha": _git_sha(),
        "torch_version": torch.__version__,
        "device_kind": kind,
        "config_hash": config_hash(config),
        "pid": str(os.getpid()),
    }
    if process is not None:
        meta["process"] = str(process)
    return meta


def write_jsonl(hub, path: str) -> int:
    """Dump a hub to a JSONL event stream and return the record count.

    Line 1 is a ``meta`` record; then every raw event (phase spans, in
    emission order) and every stream sample, each stamped with the run
    metadata under ``"run"``.

    This is :class:`RecordCursor` + :class:`JsonlWriter` — the exact
    stamping path the elastic runtime drains workers through — run once
    over a whole hub, so locally-exported and runtime-drained records can
    never skew in shape.
    """
    writer = JsonlWriter(path, hub.meta, streams=list(hub.streams))
    try:
        writer.append(RecordCursor(hub).drain(totals=True))
    finally:
        writer.close()
    return writer.count


class RecordCursor:
    """Incremental drain of a hub: each :meth:`drain` returns the records —
    events and stream samples, in the same shapes :func:`write_jsonl` emits,
    each stamped with the hub's run metadata — that arrived since the last
    drain.  The elastic runtime's workers drain once per round and ship the
    chunk over the control channel; the coordinator's :class:`JsonlWriter`
    appends the chunks to ONE merged stream file."""

    def __init__(self, hub):
        self.hub = hub
        self._event_pos = 0
        self._series_pos: Dict[Any, int] = {}

    def drain(self, *, totals: bool = False) -> list:
        """``totals=True`` additionally emits each counter's running total
        after its samples — only meaningful for a one-shot full dump (a
        periodic drainer would re-emit the totals every period; the runtime
        drains with the default and reads totals off ``/metrics`` instead).
        """
        out = []

        def stamp(rec: Dict[str, Any]) -> Dict[str, Any]:
            rec["run"] = self.hub.meta
            return rec

        events = self.hub.events
        for ev in events[self._event_pos:]:
            out.append(stamp(dict(ev)))
        self._event_pos = len(events)
        for name in self.hub.streams:
            spec = self.hub.spec(name)
            for label in self.hub.labels(name):
                steps, vals = self.hub.series(name, label)
                start = self._series_pos.get((name, label), 0)
                for step, value in zip(steps[start:], vals[start:]):
                    v = value.tolist() if hasattr(value, "tolist") else value
                    out.append(stamp({
                        "event": "sample", "stream": name,
                        "kind": spec.kind, "axis": spec.axis,
                        "label": label, "step": int(step), "value": v,
                    }))
                self._series_pos[(name, label)] = len(steps)
                if totals and spec.kind == "counter":
                    out.append(stamp({
                        "event": "total", "stream": name, "label": label,
                        "total": self.hub.total(name, label),
                    }))
        return out


class JsonlWriter:
    """Append-only JSONL sink for PRE-STAMPED records (each record carries
    its origin's ``"run"`` metadata — the coordinator merges many processes'
    cursors into one file).  Line 1 is a ``meta`` record stamped with the
    OWNING hub's metadata, mirroring :func:`write_jsonl`'s layout."""

    def __init__(self, path: str, meta: Dict[str, Any],
                 streams: Optional[list] = None):
        dirname = os.path.dirname(os.path.abspath(path))
        os.makedirs(dirname, exist_ok=True)
        self.path = path
        self.count = 0
        self._f = open(path, "w")
        head: Dict[str, Any] = {"event": "meta"}
        if streams is not None:
            head["streams"] = list(streams)
        head["run"] = dict(meta)
        self.append([head])

    def append(self, records) -> int:
        for rec in records:
            self._f.write(json.dumps(rec) + "\n")
            self.count += 1
        self._f.flush()
        return self.count

    def close(self) -> None:
        self._f.close()


def _prom_name(name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_]", "_", name)


def prometheus_text(hub, prefix: str = "repro") -> str:
    """Render the hub as Prometheus text exposition format v0.0.4.

    gauges -> latest sample; counters -> ``_total``; histograms ->
    ``_count``/``_sum``.  Per-node/replica vector samples are expanded into
    an ``index`` label so per-replica staleness/age gauges stay addressable.
    """
    import numpy as np

    lines = []
    run_labels = ",".join(
        f'{_prom_name(k)}="{v}"' for k, v in sorted(hub.meta.items())
    )
    lines.append(f"# HELP {prefix}_run_info run metadata stamp")
    lines.append(f"# TYPE {prefix}_run_info gauge")
    lines.append(f"{prefix}_run_info{{{run_labels}}} 1")

    def fmt(metric: str, value: float, label: str = "", index=None) -> str:
        parts = []
        if label:
            parts.append(f'label="{label}"')
        if index is not None:
            parts.append(f'index="{index}"')
        body = "{" + ",".join(parts) + "}" if parts else ""
        return f"{metric}{body} {float(value):g}"

    for name, entry in hub.collect().items():
        spec = entry["spec"]
        kind = spec["kind"]
        series_map = entry["series"]
        if not series_map:
            if kind == "gauge":
                continue  # a never-sampled gauge has no meaningful value
            # counters/histograms are well-defined at zero records: scrapes
            # must see `_total 0` / `_count 0` so rate() starts from zero
            series_map = {"": {"total": 0.0,
                               "summary": {"count": 0, "sum": 0.0}}}
        metric = f"{prefix}_{_prom_name(name)}"
        prom_type = {"gauge": "gauge", "counter": "counter",
                     "histogram": "summary"}[kind]
        suffix = "_total" if kind == "counter" else ""
        if spec["doc"]:
            lines.append(f"# HELP {metric}{suffix} {spec['doc']}")
        lines.append(f"# TYPE {metric}{suffix} {prom_type}")
        for label, series in series_map.items():
            if kind == "counter":
                lines.append(fmt(metric + "_total", series["total"], label))
            elif kind == "histogram":
                summ = series.get("summary", {"count": 0})
                lines.append(fmt(metric + "_count", summ.get("count", 0), label))
                lines.append(fmt(metric + "_sum", summ.get("sum", 0.0), label))
            else:
                last = series["values"][-1] if series["values"] else None
                if last is None:
                    continue
                arr = np.asarray(last)
                if arr.ndim == 0:
                    lines.append(fmt(metric, float(arr), label))
                else:
                    for i, v in enumerate(arr.ravel()):
                        lines.append(fmt(metric, float(v), label, index=i))
    return "\n".join(lines) + "\n"
