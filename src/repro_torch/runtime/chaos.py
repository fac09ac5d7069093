"""Fault-injection harness: kill / pause / resume / respawn child workers.

Counterpart of ``repro.runtime.chaos``, copied (processes and signals).

The controller owns the actual OS processes; the *numeric* consequences of
every action flow through the coordinator's membership layer — a killed
worker's socket EOFs, a paused worker's heartbeats go stale, a respawned
worker reconnects and resyncs.  Chaos never touches algorithm state.

``ChaosEvent`` is the declarative test-facing schedule: the coordinator
consumes events at round boundaries, which is what makes kill/rejoin plans
DETERMINISTIC (the dropout starts exactly at the named round, the rejoin
completes before the named round issues) and therefore bit-replayable
through ``repro_torch.scenarios.faults.RecordedFaults``.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import subprocess
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["ChaosEvent", "ChaosController", "by_round"]

#: actions the coordinator understands at a round boundary
ACTIONS = ("kill", "rejoin", "sleep", "pause", "resume")


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scheduled fault: applied just before ``round`` is issued.

    kill:    SIGKILL the worker; the coordinator waits for the EOF so the
             dropout deterministically starts at ``round``.
    rejoin:  respawn the worker and block until its resync completes, so it
             deterministically participates from ``round`` on.
    sleep:   a REAL straggler — the worker sleeps ``seconds`` before
             computing this one round (numerics unchanged: rounds are
             synchronous; the telemetry round-time streams show it).
    pause /  SIGSTOP / SIGCONT — the non-deterministic liveness path: the
    resume:  coordinator discovers the stall via heartbeat staleness, drops
             the worker mid-round and resyncs it in place when it returns.
    """

    round: int
    action: str
    worker: int
    seconds: float = 0.0

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(f"action {self.action!r} not in {ACTIONS}")


def by_round(plan: Sequence[ChaosEvent]) -> Dict[int, List[ChaosEvent]]:
    out: Dict[int, List[ChaosEvent]] = {}
    for ev in plan or ():
        out.setdefault(int(ev.round), []).append(ev)
    return out


class ChaosController:
    """Spawns and signals the worker processes of one elastic run."""

    def __init__(self, spawn_fn: Callable[[int], subprocess.Popen]):
        self._spawn_fn = spawn_fn
        self.procs: Dict[int, subprocess.Popen] = {}

    def spawn(self, worker_id: int) -> subprocess.Popen:
        old = self.procs.get(worker_id)
        if old is not None and old.poll() is None:
            raise RuntimeError(f"worker {worker_id} is already running")
        proc = self._spawn_fn(worker_id)
        self.procs[worker_id] = proc
        return proc

    def _signal(self, worker_id: int, sig: int) -> None:
        proc = self.procs.get(worker_id)
        if proc is None or proc.poll() is not None:
            raise RuntimeError(f"worker {worker_id} is not running")
        os.kill(proc.pid, sig)

    def kill(self, worker_id: int) -> None:
        self._signal(worker_id, signal.SIGKILL)
        self.procs[worker_id].wait()

    def pause(self, worker_id: int) -> None:
        self._signal(worker_id, signal.SIGSTOP)

    def resume(self, worker_id: int) -> None:
        self._signal(worker_id, signal.SIGCONT)

    def is_running(self, worker_id: int) -> bool:
        proc = self.procs.get(worker_id)
        return proc is not None and proc.poll() is None

    def shutdown(self, timeout_s: float = 10.0) -> None:
        """Reap every child: wait briefly, then escalate to SIGKILL."""
        for proc in self.procs.values():
            if proc.poll() is None:
                try:
                    os.kill(proc.pid, signal.SIGCONT)  # unfreeze paused ones
                except OSError:
                    pass
        for proc in self.procs.values():
            try:
                proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        self.procs.clear()
