"""Resync bundles: the elastic runtime's rejoin path through checkpoints.

Counterpart of ``repro.checkpoint.resync``, copied; the bundle's leaves load
as tensors on ``device`` (:func:`repro_torch.checkpoint.load_checkpoint`).

The coordinator saves the canonical run state — the flat wire leaves of the
full algorithm state (INCLUDING the gossip ``ChannelState``: residuals,
replica estimates, staleness ages, the codec PRNG key, all of which are
ordinary leaves of the state pytree) plus the sampling key — after every
round, through the same atomic ``save_checkpoint`` machinery training
checkpoints use.  A rejoining worker is restored FROM the bundle, never from
coordinator memory, so the on-disk path is exercised on every resync and a
coordinator restart can resume the group from the newest bundle.

Leaves are stored positionally (``leaf_0`` ... under a ``leaves`` node):
the coordinator operates on wire arrays and has no treedef; the worker
rebuilds its pytree from its own engine's template
(``repro_torch.runtime.engine.restore_wire_leaves``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .checkpoint import CheckpointManager, latest_step, load_checkpoint

__all__ = ["ResyncStore", "save_resync_bundle", "load_resync_bundle"]


def save_resync_bundle(
    directory: str,
    round_: int,
    leaves: Sequence[Any],
    key_data: Any,
    metadata: Optional[Dict] = None,
    manager: Optional[CheckpointManager] = None,
) -> str:
    """Save one round's wire leaves (numpy arrays or tensors) and key data."""
    tree = {
        "leaves": {f"leaf_{i}": l for i, l in enumerate(leaves)},
        "key": np.asarray(key_data),
    }
    meta = {"n_leaves": len(leaves), **(metadata or {})}
    if manager is not None:
        return manager.save(round_, tree, meta)
    from .checkpoint import save_checkpoint

    return save_checkpoint(directory, round_, tree, meta)


def load_resync_bundle(
    directory: str, round_: Optional[int] = None, device=None
) -> Tuple[List[Any], Any, int, Dict]:
    """(leaves, key_data, round, metadata) of the newest (or named) bundle,
    as tensors on ``device`` (CUDA unless the CPU is asked for)."""
    step = latest_step(directory) if round_ is None else round_
    if step is None:
        raise FileNotFoundError(f"no resync bundles in {directory}")
    tree, meta = load_checkpoint(directory, step, device=device)
    stored = tree["leaves"]
    leaves = [stored[f"leaf_{i}"] for i in range(int(meta["n_leaves"]))]
    return leaves, tree["key"], int(step), meta


class ResyncStore:
    """Per-run bundle directory with bounded retention (the rejoin path only
    ever needs the newest round, but keeping one predecessor makes a crash
    mid-save non-fatal — saves are atomic, retention is just hygiene)."""

    def __init__(self, directory: str, keep: int = 2, device=None):
        self.directory = directory
        self.device = device
        self._manager = CheckpointManager(directory, keep=keep)

    def save(self, round_: int, leaves: Sequence[Any],
             key_data: Any, metadata: Optional[Dict] = None) -> str:
        return save_resync_bundle(
            self.directory, round_, leaves, key_data, metadata,
            manager=self._manager,
        )

    def load(self, round_: Optional[int] = None):
        return load_resync_bundle(self.directory, round_, self.device)
