"""Length-prefixed message framing for the runtime's TCP control channel.

Counterpart of ``repro.runtime.protocol``, copied: sockets, pickle and the
standard library, with the same framing and the same byte counts.

One message = 8-byte big-endian length + a pickled dict with a ``"type"``
key.  Pickle (protocol 4) is the right tool here because control messages
carry numpy leaf lists (state rows, batches, packed snapshot payloads) --
this is a *trusted* control plane between processes an operator launched,
not an internet-facing protocol.

The elastic runtime's liveness, round dispatch and state resync ride it,
and so does the serving plane's snapshot feed
(``repro_torch.serving.remote``).
"""
from __future__ import annotations

import pickle
import socket
import struct
import threading
from typing import Any, Dict, Optional, Tuple

__all__ = [
    "send_msg", "recv_msg", "recv_msg_sized", "MessageSocket",
    "connect_with_retry", "TRACE_FIELD", "attach_trace",
]

_LEN = struct.Struct(">Q")

#: the causal-tracing carrier: every round-scoped control message (round,
#: gather, resync) carries the coordinator-minted per-round trace id under
#: this key; workers tag their span events with it so the coordinator-side
#: drain can stitch all processes' spans into one timeline
#: (``repro.telemetry.trace``).  Optional on the wire — old peers ignore it.
TRACE_FIELD = "trace"


def attach_trace(msg: Dict[str, Any], trace: Optional[str]) -> Dict[str, Any]:
    """Stamp ``msg`` with the round's trace id (no-op for ``trace=None``)."""
    if trace is not None:
        msg[TRACE_FIELD] = trace
    return msg
#: hard cap on one control message (corrupt length prefixes fail fast
#: instead of attempting a multi-GB allocation)
MAX_MESSAGE_BYTES = 1 << 33


def send_msg(sock: socket.socket, msg: Dict[str, Any]) -> int:
    """Send one framed message; returns the on-wire byte count (frame + body)."""
    blob = pickle.dumps(msg, protocol=4)
    sock.sendall(_LEN.pack(len(blob)) + blob)
    return _LEN.size + len(blob)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def recv_msg_sized(
    sock: socket.socket,
) -> Tuple[Optional[Dict[str, Any]], int]:
    """One framed message plus its on-wire size, or (None, 0) on clean EOF."""
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None, 0
    (n,) = _LEN.unpack(head)
    if n > MAX_MESSAGE_BYTES:
        raise ValueError(f"control message of {n} bytes exceeds cap")
    body = _recv_exact(sock, n)
    if body is None:
        return None, 0
    return pickle.loads(body), _LEN.size + n


def recv_msg(sock: socket.socket) -> Optional[Dict[str, Any]]:
    """One framed message, or None on a clean EOF."""
    return recv_msg_sized(sock)[0]


class MessageSocket:
    """A socket plus a send lock, so a heartbeat thread and the main loop can
    both write without interleaving frames.

    Every framed byte through ``send``/``recv`` is counted (``tx_bytes`` /
    ``rx_bytes``) — the measured per-round link traffic the wire-true
    transport work reports, as opposed to an analytic payload model."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._send_lock = threading.Lock()
        self.tx_bytes = 0
        self.rx_bytes = 0

    def send(self, msg: Dict[str, Any]) -> None:
        with self._send_lock:
            self.tx_bytes += send_msg(self.sock, msg)

    def recv(self) -> Optional[Dict[str, Any]]:
        msg, n = recv_msg_sized(self.sock)
        self.rx_bytes += n
        return msg

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


def connect_with_retry(address: str, timeout_s: float = 30.0) -> MessageSocket:
    """Dial ``host:port``, retrying until the coordinator is listening."""
    import time

    host, port = address.rsplit(":", 1)
    deadline = time.monotonic() + timeout_s
    last: Optional[Exception] = None
    while time.monotonic() < deadline:
        try:
            return MessageSocket(socket.create_connection((host, int(port)), timeout=10.0))
        except OSError as e:  # not up yet
            last = e
            time.sleep(0.1)
    raise ConnectionError(f"could not reach coordinator at {address}: {last}")
