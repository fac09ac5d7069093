"""Pull-based remote snapshot subscribers over the runtime's control channel.

Counterpart of ``repro.serving.remote``.  The in-process
:class:`~repro_torch.serving.ReplicaSet` treats an inference replica as one
more gossip subscriber; this module puts a real socket between the two
halves of that contract.  The training side runs a :class:`SnapshotFeed` --
:meth:`SnapshotPublisher.publish_packed` per round, with every packed
message (send mask + ENCODED payload + seq and seed key, never the raw
parameters unless the codec is the identity) copied to host numpy,
appended to an in-memory log and served over the length-prefixed
:class:`~repro_torch.runtime.protocol.MessageSocket` framing.  A
:class:`RemoteReplica` dials in and PULLS whatever messages it has not yet
applied:

    feed = SnapshotFeed(publisher, params)          # training process
    for round in training:
        state = run_round(state)
        feed.publish(node_mean(state.params))

    sub = RemoteReplica(feed.address, publisher, params)   # serving process
    sub.pull()                                             # catch up
    serve(sub.params_for(0))

Because the publisher itself advances through ``apply_packed``, a remote
replica that has applied the publisher's messages in sequence holds a
snapshot state BYTE-EQUAL to the feed's: the wire adds latency, never
drift.  The measured link traffic (``MessageSocket.tx_bytes`` /
``rx_bytes``) scales with the codec's wire bytes, not the parameter count.

numpy has no bfloat16: a bf16 tensor crosses as its 16-bit words (an int16
array) in a ``("bfloat16", words)`` pair and is viewed back on arrival.

The trust model is the runtime control plane's (pickled frames between
processes the operator launched), not an internet-facing API.
"""
from __future__ import annotations

import socket
import threading
from typing import Any, List, Optional

import numpy as np
import torch

from ..compression.base import Packed
from ..device import resolve_device
from ..runtime.protocol import MessageSocket, connect_with_retry
from ..tree import tree_map
from .replicas import host_info
from .snapshot import SnapshotPublisher, SnapshotState

Tree = Any

__all__ = ["SnapshotFeed", "RemoteReplica"]


def _to_host(t: torch.Tensor):
    # always a copy: on the CPU the identity payload is a view of the live
    # parameters, which the trainer goes on updating in place
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return ("bfloat16", t.view(torch.int16).numpy())
    return t.numpy()


def _to_device(a, device) -> torch.Tensor:
    if isinstance(a, tuple):
        _, words = a
        return torch.from_numpy(words).to(device).view(torch.bfloat16)
    return torch.from_numpy(a).to(device)


def _map_payload(fn, payload: Tree) -> Tree:
    return tree_map(
        lambda l: Packed({k: fn(v) for k, v in l.data.items()}, l.meta)
        if isinstance(l, Packed) else fn(l), payload)


def _host_packed(packed) -> dict:
    """Device -> host numpy, so the log (and the pickled frames) never pin
    device buffers or alias live parameters."""
    return dict(packed, sent=_to_host(packed["sent"]),
                payload=_map_payload(_to_host, packed["payload"]))


def _unwire_packed(packed, device) -> dict:
    return dict(packed, sent=_to_device(packed["sent"], device),
                payload=_map_payload(lambda a: _to_device(a, device), packed["payload"]))


class SnapshotFeed:
    """Training-side publisher + snapshot wire server (one thread per
    subscriber connection).

    Serves three request types:

      * ``fetch``  {"since": n} -> ``packed`` {"messages": log[n:], "seq"}
      * ``stat``   {}           -> ``stat``   {"seq", "tag", "bounds"}
      * ``close``  (or EOF)     -> connection teardown
    """

    def __init__(
        self,
        publisher: SnapshotPublisher,
        params: Tree,
        key: Optional[int] = None,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.publisher = publisher
        self.state: SnapshotState = publisher.init(params, key=key)
        self._log: List[Any] = []
        self._lock = threading.Lock()
        self._conns: List[MessageSocket] = []
        self._closed = False
        self._listener = socket.create_server((host, port))
        self.address = f"{host}:{self._listener.getsockname()[1]}"
        threading.Thread(
            target=self._accept_loop, daemon=True, name="snapshot-feed-accept"
        ).start()

    # -- training side --------------------------------------------------
    def publish(self, live_params: Tree) -> dict:
        """One publish tick: advance the publisher state, append the packed
        message (host numpy) to the wire log, return the host info dict."""
        self.state, info, packed = self.publisher.publish_packed(self.state, live_params)
        wire = _host_packed(packed)
        with self._lock:
            self._log.append(wire)
        return host_info(info)

    @property
    def seq(self) -> int:
        with self._lock:
            return len(self._log)

    def link_bytes(self) -> dict:
        """Measured framed bytes across every subscriber socket so far."""
        with self._lock:
            tx = sum(c.tx_bytes for c in self._conns)
            rx = sum(c.rx_bytes for c in self._conns)
        return {"tx": tx, "rx": rx, "total": tx + rx}

    # -- wire side ------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                raw, _ = self._listener.accept()
            except OSError:
                return
            conn = MessageSocket(raw)
            with self._lock:
                self._conns.append(conn)
            threading.Thread(
                target=self._serve_loop, args=(conn,), daemon=True,
                name="snapshot-feed-serve",
            ).start()

    def _serve_loop(self, conn: MessageSocket) -> None:
        try:
            while True:
                msg = conn.recv()
                if msg is None or msg.get("type") == "close":
                    return
                if msg.get("type") == "fetch":
                    since = int(msg.get("since", 0))
                    with self._lock:
                        batch = list(self._log[since:])
                        seq = len(self._log)
                    conn.send({"type": "packed", "since": since,
                               "seq": seq, "messages": batch})
                elif msg.get("type") == "stat":
                    conn.send({"type": "stat", "seq": self.seq,
                               "tag": self.publisher.tag,
                               "bounds": self.publisher.bounds})
        except OSError:
            return

    def close(self) -> None:
        self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = list(self._conns), []
        for c in conns:
            c.close()


class RemoteReplica:
    """Serving-side subscriber: pulls packed messages and applies them in
    sequence through the publisher's own ``apply_packed``, so its snapshot
    state stays byte-equal with the feed's.  Its snapshots live on
    ``device``: CUDA unless the CPU is asked for."""

    def __init__(
        self,
        address: str,
        publisher: SnapshotPublisher,
        params: Tree,
        key: Optional[int] = None,
        device=None,
    ):
        self.publisher = publisher
        self.device = resolve_device(device)
        self.state: SnapshotState = publisher.init(params, key=key, device=self.device)
        self.conn = connect_with_retry(address)
        self.applied = 0

    def pull(self) -> int:
        """Fetch-and-apply every message published since the last pull;
        returns how many messages were applied."""
        self.conn.send({"type": "fetch", "since": self.applied})
        msg = self.conn.recv()
        if msg is None:
            raise ConnectionError("snapshot feed closed while fetching")
        if msg.get("type") != "packed" or int(msg["since"]) != self.applied:
            raise RuntimeError(f"unexpected feed reply: {msg.get('type')}")
        for packed in msg["messages"]:
            self.state = self.publisher.apply_packed(
                self.state, _unwire_packed(packed, self.device))
            self.applied += 1
        return len(msg["messages"])

    def link_bytes(self) -> dict:
        return {"tx": self.conn.tx_bytes, "rx": self.conn.rx_bytes,
                "total": self.conn.tx_bytes + self.conn.rx_bytes}

    def params_for(self, i: int) -> Tree:
        return self.publisher.replica_params(self.state, i)

    def ages(self) -> np.ndarray:
        return self.state.age.cpu().numpy()

    def close(self) -> None:
        try:
            self.conn.send({"type": "close"})
        except OSError:
            pass
        self.conn.close()
