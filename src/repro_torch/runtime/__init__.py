"""The runtime's control channel: length-prefixed framed messages over TCP.

Counterpart of ``repro.runtime``, of which only ``protocol.py`` is ported so
far (the serving plane's snapshot feed speaks it).  The elastic runtime
itself -- coordinator, workers, chaos control, replay -- is ROADMAP queue 1
item 9; asking this package for one of its names raises
``NotImplementedError`` naming that item.
"""
from .protocol import (
    MAX_MESSAGE_BYTES, TRACE_FIELD, MessageSocket, attach_trace, connect_with_retry, recv_msg,
    recv_msg_sized, send_msg,
)

__all__ = [
    "send_msg", "recv_msg", "recv_msg_sized", "MessageSocket", "connect_with_retry",
    "TRACE_FIELD", "attach_trace", "MAX_MESSAGE_BYTES",
]

#: the reference's elastic-runtime names, not ported yet
_NOT_PORTED = ("RuntimeConfig", "owned_nodes", "launch", "ElasticResult", "replay_scenario",
               "simulate_reference")


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"repro_torch.runtime.{name} belongs to the elastic runtime, which is not "
            "ported to repro_torch yet (ROADMAP queue 1 item 9)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
