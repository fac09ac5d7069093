"""Gossip compression on the dense engine: codecs, error feedback, channels.

Counterpart of ``repro.compression`` for what the port runs so far: the
``identity`` and ``qsgd`` codecs, ``ErrorFeedback`` (wrapping every lossy
codec by default) and the synchronous channel, driven per communication
event by a :class:`ChannelSession` in the round executor.

    alg = DSEMVR(lr=0.1, tau=4, compression="qsgd")   # sync + EF + QSGD

``compression=None`` or ``"identity"`` is structurally the uncompressed
gossip path.  ``top_k``, ``rand_k``, ``low_rank``, the ``choco`` and
``async`` channels, per-buffer channels and overlap raise
``NotImplementedError`` (ROADMAP queue 1 item 5).
"""
from .base import (
    COMPRESSORS,
    ChannelState,
    Compressor,
    ErrorFeedback,
    Packed,
    attach_channel_state,
    compression_error,
    make_compressor,
    register_compressor,
)
from .channels import (
    CHANNELS,
    ChannelSession,
    GossipChannel,
    SyncChannel,
    Transport,
    link_bytes_per_round,
    make_channel,
    register_channel,
)
from .compressors import QSGD, Identity

__all__ = [
    "COMPRESSORS", "ChannelState", "Compressor", "ErrorFeedback", "Packed",
    "attach_channel_state", "compression_error", "make_compressor",
    "register_compressor", "CHANNELS", "ChannelSession", "GossipChannel",
    "SyncChannel", "Transport", "link_bytes_per_round", "make_channel",
    "register_channel", "QSGD", "Identity",
]
