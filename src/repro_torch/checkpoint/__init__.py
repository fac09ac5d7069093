"""Tree checkpointing in the reference's format (MessagePack manifest and
numpy buffers; no package beyond numpy and torch)."""
from .checkpoint import CheckpointManager, latest_step, load_checkpoint, save_checkpoint
from .resync import ResyncStore, load_resync_bundle, save_resync_bundle

__all__ = [
    "save_checkpoint", "load_checkpoint", "latest_step", "CheckpointManager",
    "ResyncStore", "save_resync_bundle", "load_resync_bundle",
]
