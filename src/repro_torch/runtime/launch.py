"""Launch an elastic multi-host run: spawn workers, drive the coordinator.

Counterpart of ``repro.runtime.launch``.  ``launch(config, n_workers,
plan=...)`` is the programmatic entry.  Workers are REAL OS processes
(``python -m repro_torch.runtime.worker``), each building its engine on
``config.device`` -- on CUDA each makes its own context on the card, on
the CPU each takes one thread (``OMP_NUM_THREADS=1``); the chaos plan
kills/pauses/respawns them mid-run through the
:class:`~repro_torch.runtime.chaos.ChaosController` so faults exercise the
actual sockets, signals and resync paths rather than simulated masks.
"""
from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
import tempfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .chaos import ChaosController, ChaosEvent
from .config import RuntimeConfig
from .coordinator import Coordinator
from .group import ProcessGroup

__all__ = ["ElasticResult", "launch"]

_SRC_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


@dataclasses.dataclass
class ElasticResult:
    """Everything the acceptance checks and the bench need from one run."""

    config: RuntimeConfig
    n_workers: int
    final_leaves: List[np.ndarray]      # wire leaves of the canonical state
    final_key: np.ndarray               # wire key data of the sampling key
    active_log: np.ndarray              # (n_rounds, n_nodes) bool, as trained
    epochs: List[int]                   # membership epoch after each round
    round_seconds: List[float]
    resync_seconds: List[float]
    worker_records: List[dict]          # streamed telemetry from all workers
    wall_s: float
    run_dir: str                        # resync bundles + worker logs
    stream_path: Optional[str] = None
    trace_path: Optional[str] = None    # stitched Chrome/Perfetto trace file
    http_address: Optional[str] = None  # fleet-health plane URL (if served)
    diagnostics: Optional[dict] = None  # DiagnosticsMonitor.diagnose() report
    socket_bytes: Optional[dict] = None  # measured {tx, rx, total} framed bytes
    startup_seconds: float = 0.0        # coordinator start to every worker READY
    join_seconds: List[float] = dataclasses.field(default_factory=list)  # respawn to resync ack

    @property
    def rounds_per_sec(self) -> float:
        total = sum(self.round_seconds)
        return len(self.round_seconds) / total if total > 0 else float("nan")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _log_tail(path: str, n: int = 40) -> str:
    try:
        with open(path, "r", errors="replace") as f:
            return "".join(f.readlines()[-n:])
    except OSError:
        return "<no log>"


def launch(
    config: RuntimeConfig,
    n_workers: int,
    plan: Sequence[ChaosEvent] = (),
    stream_path: Optional[str] = None,
    run_dir: Optional[str] = None,
    env_overrides: Optional[Dict[str, str]] = None,
    trace_path: Optional[str] = None,
    http_port: Optional[int] = None,
) -> ElasticResult:
    """Run ``config.n_rounds`` elastic rounds over ``n_workers`` processes.

    stream_path:  when set, ALL telemetry (every worker's streams, shipped
                  over the control channel, plus the coordinator's runtime
                  streams) lands in this one run-stamped JSONL.
    run_dir:      holds resync bundles and per-worker logs (a temp dir by
                  default; kept on failure for post-mortem).
    trace_path:   when set, the coordinator stitches every process's span
                  events into ONE Chrome trace-event / Perfetto JSON file
                  (shared per-round trace ids; see
                  repro_torch.telemetry.trace).
    http_port:    when set (0 = ephemeral), serve the live fleet-health
                  plane — /metrics, /healthz, /trace, /diagnostics — from
                  the coordinator for the duration of the run.
    """
    run_dir = run_dir or tempfile.mkdtemp(prefix="repro-elastic-")
    log_dir = os.path.join(run_dir, "logs")
    resync_dir = os.path.join(run_dir, "resync")
    os.makedirs(log_dir, exist_ok=True)
    os.makedirs(resync_dir, exist_ok=True)

    group = ProcessGroup(heartbeat_timeout_s=config.heartbeat_timeout_s)

    def spawn_fn(worker_id: int) -> subprocess.Popen:
        env = os.environ.copy()
        env["PYTHONPATH"] = _SRC_ROOT + os.pathsep + env.get("PYTHONPATH", "")
        if config.device == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        env.update(env_overrides or {})
        log = open(os.path.join(log_dir, f"worker_{worker_id}.log"), "ab")
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.runtime.worker",
             "--coordinator", group.address, "--worker-id", str(worker_id)],
            env=env, stdout=log, stderr=subprocess.STDOUT, close_fds=True,
        )

    controller = ChaosController(spawn_fn)
    coordinator = Coordinator(
        config, n_workers, group,
        controller=controller, plan=plan,
        stream_path=stream_path, resync_dir=resync_dir, trace_path=trace_path,
    )
    server = None
    http_address = None
    if http_port is not None:
        from ..telemetry import FleetServer

        server = FleetServer(
            port=http_port,
            metrics=coordinator.metrics_text,
            health=coordinator.health,
            trace=coordinator.recent_trace,
            diagnostics=coordinator.diagnose,
        ).start()
        http_address = server.url
    try:
        for wid in range(n_workers):
            controller.spawn(wid)
        res = coordinator.run()
    except Exception as exc:
        tails = "\n".join(
            f"--- worker {w} log tail ---\n"
            + _log_tail(os.path.join(log_dir, f"worker_{w}.log"))
            for w in sorted(controller.procs)
        )
        raise RuntimeError(
            f"elastic run failed ({exc!r}); logs kept in {run_dir}\n{tails}"
        ) from exc
    finally:
        controller.shutdown()
        group.close()
        if server is not None:
            server.close()

    return ElasticResult(
        config=config,
        n_workers=n_workers,
        final_leaves=res.final_leaves,
        final_key=res.final_key,
        active_log=res.active_log,
        epochs=res.epochs,
        round_seconds=res.round_seconds,
        resync_seconds=res.resync_seconds,
        worker_records=res.worker_records,
        wall_s=res.wall_s,
        run_dir=run_dir,
        stream_path=stream_path,
        trace_path=res.trace_path,
        http_address=http_address,
        diagnostics=res.diagnostics,
        socket_bytes=res.socket_bytes,
        startup_seconds=res.startup_seconds,
        join_seconds=res.join_seconds,
    )
