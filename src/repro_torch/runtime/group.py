"""ProcessGroup: coordinator-side membership with heartbeats and epochs.

Counterpart of ``repro.runtime.group``, copied (sockets and threads).

The group owns the listening socket, one reader thread per worker connection
and a single event queue the coordinator drains.  Membership is EPOCHED: any
change — a worker's socket hitting EOF, its heartbeats going stale past the
timeout, a rejoin — bumps ``epoch``; every round-protocol message carries the
epoch it was issued under and the coordinator drops echoes from older epochs,
which is what makes round re-issue after a mid-round death race-free.

Two distinct ways out of the live set, with different recovery paths:

  * **dead** — the connection reached EOF (process exited / was killed).
    The handle is discarded; the worker can only come back as a fresh
    connection (HELLO with ``rejoin=True``) followed by a state resync.
  * **suspended** — the socket is open but heartbeats are stale (paused via
    SIGSTOP, wedged, or genuinely slow past the timeout).  The handle is
    kept; if heartbeats resume (SIGCONT) the coordinator resyncs it in place
    at the next round boundary, no reconnect needed.
"""
from __future__ import annotations

import dataclasses
import queue
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

from .protocol import MessageSocket, recv_msg

__all__ = ["WorkerHandle", "ProcessGroup"]


@dataclasses.dataclass
class WorkerHandle:
    worker_id: int
    conn: MessageSocket
    last_seen: float
    alive: bool = True
    suspended: bool = False


class ProcessGroup:
    def __init__(self, port: int = 0, heartbeat_timeout_s: float = 3.0,
                 host: str = "127.0.0.1"):
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.events: "queue.Queue[Tuple[str, ...]]" = queue.Queue()
        self.handles: Dict[int, WorkerHandle] = {}
        self.dead: set = set()  # EOF'd workers not (yet) reconnected
        self.epoch = 0
        # byte totals of retired (dead) connections, so socket_bytes() stays
        # monotonic across kills/rejoins
        self._retired_tx = 0
        self._retired_rx = 0
        self._lock = threading.Lock()
        self._closed = False
        self._listener = socket.create_server((host, port))
        self.address = f"{host}:{self._listener.getsockname()[1]}"
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="pg-accept"
        )
        self._accept_thread.start()

    # -- connection intake -------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                raw, _ = self._listener.accept()
            except OSError:
                return
            try:
                hello = recv_msg(raw)
            except Exception:
                raw.close()
                continue
            if not hello or hello.get("type") != "hello":
                raw.close()
                continue
            # the coordinator attaches the reader thread when it processes
            # the join at a round boundary — until then the socket is idle
            self.events.put(
                ("hello", int(hello["worker"]), bool(hello.get("rejoin", False)),
                 MessageSocket(raw))
            )

    def attach(self, worker_id: int, conn: MessageSocket) -> WorkerHandle:
        """Adopt a connection into the live set and start its reader."""
        handle = WorkerHandle(worker_id, conn, last_seen=time.monotonic())
        with self._lock:
            self.handles[worker_id] = handle
            self.dead.discard(worker_id)
        threading.Thread(
            target=self._reader_loop, args=(handle,), daemon=True,
            name=f"pg-reader-{worker_id}",
        ).start()
        return handle

    def _reader_loop(self, handle: WorkerHandle) -> None:
        while True:
            try:
                msg = handle.conn.recv()
            except Exception:
                msg = None
            if msg is None:
                if handle is self.handles.get(handle.worker_id):
                    self.events.put(("eof", handle.worker_id))
                return
            handle.last_seen = time.monotonic()
            if msg.get("type") == "heartbeat":
                continue
            self.events.put(("msg", handle.worker_id, msg))

    # -- membership --------------------------------------------------------
    def bump_epoch(self) -> int:
        self.epoch += 1
        return self.epoch

    def live(self) -> List[int]:
        return sorted(
            wid for wid, h in self.handles.items()
            if h.alive and not h.suspended
        )

    def mark_dead(self, worker_id: int) -> None:
        """EOF death: discard the handle (recovery = reconnect + resync)."""
        h = self.handles.pop(worker_id, None)
        if h is not None:
            h.alive = False
            self._retired_tx += h.conn.tx_bytes
            self._retired_rx += h.conn.rx_bytes
            h.conn.close()
        self.dead.add(worker_id)
        self.bump_epoch()

    def mark_suspended(self, worker_id: int) -> None:
        """Heartbeat-stale: keep the handle for in-place recovery."""
        h = self.handles.get(worker_id)
        if h is not None and not h.suspended:
            h.suspended = True
            self.bump_epoch()

    def recovered(self) -> List[int]:
        """Suspended workers whose heartbeats came back within the timeout."""
        now = time.monotonic()
        return sorted(
            wid for wid, h in self.handles.items()
            if h.suspended and now - h.last_seen < self.heartbeat_timeout_s
        )

    def unsuspend(self, worker_id: int) -> None:
        h = self.handles.get(worker_id)
        if h is not None:
            h.suspended = False
        self.bump_epoch()

    def stale(self) -> List[int]:
        """Live workers whose heartbeats are past the timeout."""
        now = time.monotonic()
        return [
            wid for wid in self.live()
            if now - self.handles[wid].last_seen > self.heartbeat_timeout_s
        ]

    def heartbeat_ages(self) -> Dict[int, float]:
        now = time.monotonic()
        return {wid: now - self.handles[wid].last_seen for wid in self.live()}

    def suspended(self) -> List[int]:
        return sorted(wid for wid, h in self.handles.items() if h.suspended)

    def socket_bytes(self) -> Dict[str, int]:
        """Measured control-channel traffic, coordinator side: framed bytes
        sent to / received from every worker connection (dead ones included).
        ``tx`` is round/gather/resync downlink, ``rx`` is contrib/done/
        heartbeat uplink."""
        tx = self._retired_tx + sum(
            h.conn.tx_bytes for h in self.handles.values()
        )
        rx = self._retired_rx + sum(
            h.conn.rx_bytes for h in self.handles.values()
        )
        return {"tx": tx, "rx": rx, "total": tx + rx}

    def health(self) -> Dict[str, object]:
        """One JSON-able membership snapshot — the ``/healthz`` payload's
        group half (the coordinator layers round progress on top)."""
        now = time.monotonic()
        return {
            "epoch": self.epoch,
            "live": self.live(),
            "suspended": self.suspended(),
            "dead": sorted(self.dead),
            "heartbeat_age_s": {
                str(wid): round(now - h.last_seen, 3)
                for wid, h in sorted(self.handles.items())
            },
        }

    # -- messaging ---------------------------------------------------------
    def send(self, worker_id: int, msg: dict) -> bool:
        h = self.handles.get(worker_id)
        if h is None or not h.alive:
            return False
        try:
            h.conn.send(msg)
            return True
        except OSError:
            # the reader thread will surface the EOF event; don't double-report
            return False

    def next_event(self, timeout: Optional[float] = None):
        try:
            return self.events.get(timeout=timeout)
        except queue.Empty:
            return None

    def close(self) -> None:
        self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass
        for h in list(self.handles.values()):
            h.conn.close()
        self.handles.clear()
