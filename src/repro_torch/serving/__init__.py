"""Decentralized serving plane: inference replicas as gossip subscribers.

Counterpart of ``repro.serving``.  Serving replicas subscribe to the live
training loop through the same codecs the gossip channels use:

  * :class:`SnapshotPublisher` / :class:`SnapshotState` -- CHOCO-style
    difference publishing of wire-quantized parameter snapshots
    (``snapshot.py``);
  * :class:`ReplicaSet` -- the subscriber set: dequantized snapshots with a
    per-replica staleness bound (the freshness SLO) and the serving metrics
    streams (``replicas.py`` / ``metrics.py``);
  * :class:`SnapshotFeed` / :class:`RemoteReplica` -- the same contract over
    a real socket: pull-based packed-snapshot fetch on the runtime's framed
    control channel, byte-equal with the in-process subscriber
    (``remote.py``);
  * :func:`scan_prefill` / :class:`RequestDriver` -- prefill by decode steps
    and continuous batching over ``Model.decode_step`` (``driver.py``).

See README "PyTorch port" and ``examples/serve_while_training_torch.py``.
"""
from .driver import RequestDriver, scan_prefill
from .metrics import SERVING_STREAM_FIELDS, ServingMetrics
from .remote import RemoteReplica, SnapshotFeed
from .replicas import ReplicaSet
from .snapshot import SnapshotPublisher, SnapshotState

__all__ = [
    "SnapshotPublisher",
    "SnapshotState",
    "ReplicaSet",
    "SnapshotFeed",
    "RemoteReplica",
    "ServingMetrics",
    "SERVING_STREAM_FIELDS",
    "RequestDriver",
    "scan_prefill",
]
