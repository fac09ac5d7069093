"""Quantized parameter snapshots: the training -> serving wire format.

Counterpart of ``repro.serving.snapshot``.  The serving plane treats an
inference replica as *one more gossip subscriber*: replicas hold a
dequantized snapshot of the live trained parameters that the training loop
refreshes through the same codecs the gossip channels use
(``repro_torch.compression``).

  * :class:`SnapshotPublisher` -- the encoder side, called after each
    training round.  It keeps one replica estimate ``x̂_r`` per subscriber
    (the CHOCO idiom: the replica IS the shared memory), encodes the
    *difference* ``q(x - x̂_r)`` through the snapshot codec, and applies the
    decoded difference to its copy of ``x̂_r`` through :meth:`apply_packed`,
    the one function a subscriber applies too, so publisher and replica
    estimates never diverge.
  * :class:`SnapshotState` -- the replica-stacked wire state (leading axis
    R = number of replicas): the dequantized snapshots ``hat``, per-replica
    staleness ``age`` and the last publish's ``sent`` mask.

Refresh policy per replica r (the drift term is opt-in; ``threshold=None``
makes refreshes purely bound-driven):

    send_r = (age_r + 1 >= bound_r)  OR  ||x - x̂_r||^2 > θ^2 (||x||^2 + 1e-12)

so ``age_r <= bound_r - 1`` after every publish: the freshness SLO.

Randomness is injected: a stochastic codec takes a uint32 seed per leaf
where the reference splits a PRNG key per publish and folds in the leaf
index.  The seeds of publish ``seq`` come from ``seed_fn(seq, leaf)``; by
default they are derived on the host from the state's integer ``key`` with
``np.random.SeedSequence``, so no draw waits on the device.  Parity tests
replay the reference's key chain and inject it.

Unlike JAX arrays, the trainer's tensors change in place (``p.sub_``).  So
no snapshot ever aliases a live tensor: the identity path's payload is a
broadcast *view* of the live parameters, valid only until they next
change, and :meth:`apply_packed` copies it into fresh tensors
(``torch.where`` allocates).  A bound-1 identity replica therefore serves
the live parameters bit for bit as they were at the publish.

The publish walks the tree leaf by leaf: one leaf's fp32 difference is
alive at a time, and the payload holds only encoded leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ..compression.base import Compressor, ErrorFeedback, Packed, make_compressor
from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

Tree = Any
#: (publish seq, leaf index) -> the leaf's uint32 codec seed
SnapshotSeedFn = Callable[[int, int], int]

__all__ = ["SnapshotState", "SnapshotPublisher", "default_snapshot_seed_fn"]

_SNAPSHOT_TAG = 0x736E   # keeps the snapshot seed stream apart from the gossip's


def default_snapshot_seed_fn(key: int) -> SnapshotSeedFn:
    """Host-side codec seeds: one uint32 per (publish, leaf), drawn from
    ``np.random.SeedSequence`` keyed on ``key``."""

    def seed_fn(seq: int, leaf: int) -> int:
        entropy = [int(key), _SNAPSHOT_TAG, int(seq), int(leaf)]
        return int(np.random.SeedSequence(entropy).generate_state(1)[0])

    return seed_fn


@dataclasses.dataclass
class SnapshotState:
    """Replica-stacked snapshot wire state (leading axis R on every leaf of
    ``hat``), carried by :class:`~repro_torch.serving.ReplicaSet`."""

    hat: Tree              # (R, ...) dequantized snapshots: what replicas serve
    age: torch.Tensor      # (R,) int32 publishes since the last refresh
    sent: torch.Tensor     # (R,) bool, the last publish's refresh mask
    seq: int               # publishes applied so far
    key: int               # the integer the default seed_fn derives seeds from


def _replica_mask(send: torch.Tensor, ndim: int) -> torch.Tensor:
    return send.reshape((send.shape[0],) + (1,) * (ndim - 1))


@dataclasses.dataclass(frozen=True)
class SnapshotPublisher:
    """Declarative snapshot-publishing spec (frozen).

    codec:     snapshot wire codec -- a ``repro_torch.compression`` registry
               name ("identity", "qsgd", "top_k:0.1", ...) or a ready
               ``Compressor``.  Difference publishing replaces error
               feedback (the replica is the memory), so an ``ErrorFeedback``
               wrapper is unwrapped.  "identity"/None is the raw path:
               refreshed snapshots are copies of the live parameters.
    bounds:    per-replica staleness bounds (R = len(bounds)); at most
               ``bounds[r] - 1`` publishes may pass without a refresh.
    threshold: relative-drift trigger θ -- a replica also refreshes early
               when ``||x - x̂_r||^2 > θ^2 ||x||^2``.  ``None`` (default)
               disables it; θ = 0 means "refresh on ANY drift".
    seed_fn:   ``(seq, leaf) -> uint32`` codec seeds of publish ``seq``;
               None derives them from the state's ``key``
               (:func:`default_snapshot_seed_fn`).
    """

    codec: Any = None
    bounds: Tuple[int, ...] = (1,)
    threshold: Optional[float] = None
    seed_fn: Optional[SnapshotSeedFn] = None

    def __post_init__(self):
        if not self.bounds:
            raise ValueError("SnapshotPublisher needs at least one replica bound")
        bounds = tuple(int(b) for b in self.bounds)
        if any(b < 1 for b in bounds):
            raise ValueError(f"staleness bounds must be >= 1, got {self.bounds}")
        object.__setattr__(self, "bounds", bounds)
        if self.threshold is not None and float(self.threshold) < 0.0:
            raise ValueError(f"threshold must be >= 0, got {self.threshold}")
        codec = self.codec
        if codec is not None and not isinstance(codec, Compressor):
            codec = make_compressor(codec)
        if isinstance(codec, ErrorFeedback):
            # the replica estimate is the error memory: a residual on top
            # would count the quantization error twice
            codec = codec.inner
        if codec is not None and codec.is_identity:
            codec = None
        object.__setattr__(self, "codec", codec)

    @property
    def n_replicas(self) -> int:
        return len(self.bounds)

    @property
    def tag(self) -> str:
        return "raw" if self.codec is None else self.codec.tag

    # ------------------------------------------------------------------
    def init(self, params: Tree, key: Optional[int] = None, device=None) -> SnapshotState:
        """Zero snapshots on ``device`` (default: the parameters'), ages
        poised so the FIRST publish refreshes every replica."""
        r = self.n_replicas
        dev = torch.device(device) if device is not None else tree_leaves(params)[0].device
        return SnapshotState(
            hat=tree_map(lambda p: torch.zeros((r,) + tuple(p.shape), dtype=p.dtype, device=dev),
                         params),
            age=torch.tensor(self.bounds, dtype=torch.int32, device=dev) - 1,
            sent=torch.zeros((r,), dtype=torch.bool, device=dev),
            seq=0,
            key=0 if key is None else int(key),
        )

    def publish(self, state: SnapshotState, params: Tree):
        """One publish tick: ``(new_state, info)``.

        ``info`` holds (R,) tensors on the state's device: the ``sent``
        mask, the post-publish ``age``, the relative ``drift`` and the
        analytic wire ``bytes`` each replica's link moved (0 for replicas
        that kept their snapshot)."""
        new_state, info, _packed = self.publish_packed(state, params)
        return new_state, info

    def publish_packed(self, state: SnapshotState, params: Tree):
        """Publish AND hand back the wire message: ``(new_state, info,
        packed)``.

        ``packed`` is what a subscriber needs to advance its own copy of the
        state (:meth:`apply_packed`): the send mask, the ENCODED payload
        (for a lossy codec the quantized difference, not the parameters),
        the publish's ``seq`` and the state's seed ``key``.  ``new_state``
        is the publisher applying its own message."""
        r = self.n_replicas
        leaves, treedef = tree_flatten(params)
        hats, hat_def = tree_flatten(state.hat)
        if hat_def != treedef:
            raise ValueError("params and snapshots differ in tree structure")
        seed_fn = self.seed_fn or default_snapshot_seed_fn(state.key)
        drift2 = ref2 = 0
        encoded = []
        for i, (p, h) in enumerate(zip(leaves, hats)):
            x = p.detach().float()
            diff = x.unsqueeze(0) - h.float()
            drift2 = drift2 + torch.sum((diff * diff).reshape(r, -1), dim=1)
            ref2 = ref2 + torch.sum(x * x)
            if self.codec is not None:
                encoded.append(self.codec.encode(diff, seed_fn(state.seq, i)))
            del diff
        ref2 = ref2.expand(r)   # every replica compares against the same live tree
        bounds = torch.tensor(self.bounds, dtype=torch.int32, device=state.age.device)
        send = (state.age + 1) >= bounds
        if self.threshold is not None:
            thr = np.float32(self.threshold)
            send = send | (drift2 > (ref2 + 1e-12) * float(thr * thr))

        if self.codec is None:
            # raw path: the payload is the live tree itself, viewed R times
            payload = tree_unflatten(treedef, [
                p.detach().unsqueeze(0).expand((r,) + tuple(p.shape)) for p in leaves])
        else:
            payload = tree_unflatten(treedef, encoded)
        packed = {"sent": send, "payload": payload, "seq": state.seq, "key": state.key}
        new_state = self.apply_packed(state, packed)
        per_replica_bytes = float(np.float32(self.message_bytes(params)))
        info = {
            "sent": send,
            "age": new_state.age,
            "drift": torch.sqrt(drift2 / (ref2 + 1e-12)),
            "bytes": send.to(torch.float32) * per_replica_bytes,
        }
        return new_state, info, packed

    def apply_packed(self, state: SnapshotState, packed) -> SnapshotState:
        """Advance a snapshot state by one published message.

        This is the SUBSCRIBER side of the wire: a remote replica holding its
        own :class:`SnapshotState` applies the publisher's messages in
        sequence and stays byte-equal with the publisher's estimate, because
        the publisher itself advances through this function.  A message out
        of sequence raises."""
        if int(packed["seq"]) != state.seq:
            raise ValueError(f"snapshot message {packed['seq']} applied to a state at "
                             f"publish {state.seq}")
        send = packed["sent"]
        hats, treedef = tree_flatten(state.hat)
        payload = tree_leaves(packed["payload"])
        if len(payload) != len(hats):
            raise ValueError("snapshot payload and snapshots differ in tree structure")
        new = []
        for pl, h in zip(payload, hats):
            if self.codec is None:
                new.append(torch.where(_replica_mask(send, h.dim()), pl, h))
                continue
            dec = self.codec.decode(pl).float()
            step = torch.where(_replica_mask(send, dec.dim()), dec, 0.0)
            del dec
            new.append(step.add_(h.float()).to(h.dtype))
        return SnapshotState(
            hat=tree_unflatten(treedef, new),
            age=torch.where(send, 0, state.age + 1).to(torch.int32),
            sent=send,
            seq=state.seq + 1,
            key=int(packed["key"]),
        )

    def packed_bytes(self, packed) -> int:
        """ACTUAL bytes of one packed message's tensors (what a host copy
        moves): compare with :meth:`message_bytes` and the raw size."""
        tensors = [packed["sent"]]
        for leaf in tree_leaves(packed["payload"]):
            tensors += list(leaf.data.values()) if isinstance(leaf, Packed) else [leaf]
        return sum(t.numel() * t.element_size() for t in tensors)

    # ------------------------------------------------------------------
    def message_bytes(self, params: Tree) -> int:
        """Analytic wire bytes of ONE snapshot message (per replica link):
        the codec's payload model, or the raw tree size for the identity
        path."""
        if self.codec is not None:
            return self.codec.tree_bytes(params)
        return sum(l.numel() * l.element_size() for l in tree_leaves(params))

    def replica_params(self, state: SnapshotState, i: int) -> Tree:
        """The dequantized snapshot replica ``i`` currently serves (views of
        ``state.hat``, which no publish writes in place)."""
        return tree_map(lambda h: h[i], state.hat)
