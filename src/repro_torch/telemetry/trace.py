"""Cross-process causal tracing: one timeline for the whole fleet.

Counterpart of ``repro.telemetry.trace``, copied (standard library only).
Phase spans and the multi-process runtime each observe their own process: every worker fences local/gossip/resync spans into its own hub, the
coordinator times rounds and resyncs in its hub, and the merged JSONL stream
interleaves them without any causal glue.  This module adds the glue:

  * the coordinator mints a **per-round trace id** (``round_trace_id``) and
    carries it on every round-scoped control-channel message (see
    ``repro_torch.runtime.protocol.attach_trace``);
  * every process records its spans through a :class:`TraceRecorder`, which
    stamps each span event with a **wall-clock anchor** (``t0``), duration
    and the trace id it was working under — these events ride the existing
    run-stamped record stream (``RecordCursor`` over the control channel for
    workers, the coordinator's own hub locally), so stitching needs no new
    transport;
  * :func:`trace_events` stitches any collection of stamped records into
    Chrome trace-event JSON (the format Perfetto / ``chrome://tracing`` load
    directly): one track per process (pid from the run stamp, named by its
    ``process`` role), ``X`` duration events for spans, ``i`` instants for
    membership transitions, the shared trace id + round + epoch in ``args``.

A 4-process kill+rejoin run therefore renders as ONE timeline: the abandoned
round attempt on the coordinator track (``abandoned: true`` in its args),
the epoch-bump instant, the rejoining worker's ``resync`` span and the
re-sent round's spans on every surviving worker — all joined by the same
per-round trace id.

Wall-clock anchors (``time.time()``) are comparable across processes on one
host, which is the elastic runtime's deployment unit; cross-host skew would
shift tracks relative to each other but never corrupt intra-process timing
or the trace-id causality.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
import uuid
from typing import Any, Dict, Iterable, Iterator, List, Optional

__all__ = [
    "new_run_id",
    "round_trace_id",
    "TraceRecorder",
    "trace_events",
    "trace_index",
    "write_chrome_trace",
]

#: event kinds a hub record must carry to be stitchable (plus a ``t0`` anchor)
_SPAN_EVENTS = ("span", "instant")


def new_run_id() -> str:
    """A short random run id — the prefix every round trace id shares."""
    return uuid.uuid4().hex[:8]


def round_trace_id(run_id: str, round_: int) -> str:
    """The ONE trace id for round ``round_``: every attempt of the round
    (including abandoned ones after a mid-round death), the resyncs that
    re-admit workers into it and every worker's phase spans all carry it."""
    return f"{run_id}/r{int(round_):05d}"


class TraceRecorder:
    """Wall-clock-anchored span/instant recorder over a telemetry hub.

    Unlike :func:`repro_torch.telemetry.spans.span` (host timers for the
    single-process engines, active only when ``hub.spans``), the recorder is
    explicit — the runtime opts in per call site — and every event carries
    the ``t0`` anchor + trace id the cross-process stitcher needs.  Span
    durations are additionally folded into the hub's ``span_seconds``
    histogram so ``/metrics`` exposes per-phase timing without reading the
    event stream.  With ``hub`` None every method is a no-op.
    """

    def __init__(self, hub):
        self.hub = hub

    @contextlib.contextmanager
    def span(self, phase: str, *, trace: Optional[str] = None,
             step: Optional[int] = None, epoch: Optional[int] = None,
             ) -> Iterator[Dict[str, Any]]:
        """Time one phase; yields a dict the caller may add extra args to
        (e.g. ``info["abandoned"] = True``) before the span closes."""
        info: Dict[str, Any] = {}
        if self.hub is None:
            yield info
            return
        t0 = time.time()
        p0 = time.perf_counter()
        try:
            yield info
        finally:
            dt = time.perf_counter() - p0
            ev: Dict[str, Any] = {
                "event": "span", "phase": phase, "step": step,
                "seconds": dt, "t0": t0,
            }
            if trace is not None:
                ev["trace"] = trace
            if epoch is not None:
                ev["epoch"] = epoch
            ev.update(info)
            self.hub.record_event(ev)
            self.hub.record("span_seconds", dt, step=step, label=phase)

    def instant(self, name: str, *, trace: Optional[str] = None,
                step: Optional[int] = None, **args: Any) -> None:
        """A zero-duration marker (epoch bump, kill observed, ...)."""
        if self.hub is None:
            return
        ev: Dict[str, Any] = {
            "event": "instant", "phase": name, "step": step, "t0": time.time(),
        }
        if trace is not None:
            ev["trace"] = trace
        ev.update(args)
        self.hub.record_event(ev)


# --------------------------------------------------------------- stitching
_ARG_KEYS = ("trace", "epoch", "abandoned", "worker", "reason", "to_epoch")


def _pid_of(rec: Dict[str, Any]) -> int:
    run = rec.get("run") or {}
    try:
        return int(run.get("pid", 0))
    except (TypeError, ValueError):
        return 0


def trace_events(records: Iterable[Dict[str, Any]],
                 base_ts: Optional[float] = None) -> List[Dict[str, Any]]:
    """Stitch stamped span/instant records into Chrome trace events.

    ``records`` are JSONL-shaped hub records (each with its origin's ``run``
    stamp) from ANY number of processes; records without a ``t0`` wall-clock
    anchor (e.g. the single-process engines' plain spans) are skipped.
    Returns ``process_name`` metadata events followed by the span/instant
    events sorted by timestamp within each (pid, tid) track — the Chrome
    trace-event contract Perfetto expects.
    """
    spans = [
        r for r in records
        if r.get("event") in _SPAN_EVENTS and r.get("t0") is not None
    ]
    if not spans:
        return []
    if base_ts is None:
        base_ts = min(float(r["t0"]) for r in spans)

    procs: Dict[int, str] = {}
    out: List[Dict[str, Any]] = []
    for r in spans:
        pid = _pid_of(r)
        run = r.get("run") or {}
        procs.setdefault(pid, str(run.get("process", f"pid:{pid}")))
        args = {k: r[k] for k in _ARG_KEYS if r.get(k) is not None}
        if r.get("step") is not None:
            args["round"] = int(r["step"])
        ev: Dict[str, Any] = {
            "name": str(r.get("phase", "?")),
            "cat": "repro",
            "ts": round((float(r["t0"]) - base_ts) * 1e6, 1),
            "pid": pid,
            "tid": 1,
            "args": args,
        }
        if r["event"] == "span":
            ev["ph"] = "X"
            ev["dur"] = round(float(r.get("seconds", 0.0)) * 1e6, 1)
        else:
            ev["ph"] = "i"
            ev["s"] = "p"
        out.append(ev)
    out.sort(key=lambda e: (e["pid"], e["tid"], e["ts"]))
    meta = [
        {"name": "process_name", "ph": "M", "pid": pid, "tid": 1,
         "args": {"name": name}}
        for pid, name in sorted(procs.items())
    ]
    return meta + out


def trace_index(events: Iterable[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Summarize stitched events per trace id: which pids and phases carried
    it, which round it belongs to, whether an attempt was abandoned.  The CI
    smoke and the acceptance tests assert on this view."""
    idx: Dict[str, Dict[str, Any]] = {}
    for ev in events:
        trace = (ev.get("args") or {}).get("trace")
        if trace is None:
            continue
        entry = idx.setdefault(trace, {
            "pids": set(), "phases": set(), "rounds": set(), "abandoned": False,
        })
        entry["pids"].add(ev["pid"])
        entry["phases"].add(ev["name"])
        if "round" in ev["args"]:
            entry["rounds"].add(int(ev["args"]["round"]))
        if ev["args"].get("abandoned"):
            entry["abandoned"] = True
    for entry in idx.values():
        entry["pids"] = sorted(entry["pids"])
        entry["phases"] = sorted(entry["phases"])
        entry["rounds"] = sorted(entry["rounds"])
    return idx


def write_chrome_trace(path: str, records: Iterable[Dict[str, Any]]) -> int:
    """Stitch ``records`` and write a Perfetto-loadable trace file; returns
    the number of trace events written (0 leaves an empty-but-valid file)."""
    events = trace_events(records)
    dirname = os.path.dirname(os.path.abspath(path))
    os.makedirs(dirname, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return len(events)
