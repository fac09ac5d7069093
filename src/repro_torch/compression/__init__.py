"""Gossip compression on the dense engine: codecs, error feedback, channels.

Counterpart of ``repro.compression``.  Three declarative axes compose one
communication event:

  * the codec (``Compressor`` registry: identity, qsgd, top_k, rand_k,
    low_rank; ``ErrorFeedback`` wraps every lossy codec by default);
  * the channel (``GossipChannel`` registry: ``sync``, ``choco`` difference
    gossip, ``async`` stale-mix; ``PerBufferChannel`` for per-buffer
    mappings; ``overlap`` double-buffers choco and async sends), whose
    per-buffer wire state rides in the algorithm state's ``comp`` field;
  * the transport (``Transport``): the Simulator's dense W contraction.

    alg = DSEMVR(lr=0.1, tau=4, compression="top_k:0.1", channel="choco")

``compression=None`` or ``"identity"`` with the sync channel is structurally
the uncompressed gossip path, and so is ``"async:1"`` with no codec.  The
sharded engine's transports are ROADMAP queue 1 item 8.
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
    AsyncChannel,
    ChannelSession,
    ChocoChannel,
    GossipChannel,
    PerBufferChannel,
    SyncChannel,
    Transport,
    link_bytes_per_round,
    make_channel,
    register_channel,
)
from .compressors import QSGD, Identity, LowRank, RandK, TopK

__all__ = [
    "COMPRESSORS", "ChannelState", "Compressor", "ErrorFeedback", "Packed",
    "attach_channel_state", "compression_error", "make_compressor",
    "register_compressor", "CHANNELS", "ChannelSession", "GossipChannel",
    "SyncChannel", "ChocoChannel", "AsyncChannel", "PerBufferChannel", "Transport",
    "link_bytes_per_round", "make_channel", "register_channel",
    "QSGD", "Identity", "TopK", "RandK", "LowRank",
]
