"""Multi-process elastic runtime: the round executor across real OS processes.

Counterpart of ``repro.runtime``.  The SAME round executor the Simulator
runs (``repro_torch.core.make_round_step``, scheduled) runs as a
coordinator + worker process group over a TCP control channel, and the
scenario engine's fault models map onto *actual* membership:

  * a **dropped node** is a worker that stops heartbeating -- the
    coordinator bumps the membership epoch and rewrites W_t with the
    doubly-stochastic renormalization the simulated ``Dropout`` fault uses
    (``repro_torch.scenarios.renormalize_dropout``);
  * a **straggler** is a worker with injected real sleep -- round-time
    telemetry shows it, the numerics don't change (rounds are synchronous);
  * a **rejoin** resyncs through the checkpoint + ``ChannelState`` machinery
    (``repro_torch.checkpoint.ResyncStore``) and the restored worker
    continues **bit-identically**.

The observed membership replays through the Simulator via the ``recorded``
fault model (``repro_torch.scenarios.RecordedFaults``): the elastic run and
a single-process run of the same fault schedule give bit-identical states.
Workers run on ``RuntimeConfig.device`` (CUDA unless it says "cpu"); on the
card every fused op of the run launches its hand-written kernel in each
worker's own process.

Entry points:

  * :func:`repro_torch.runtime.launch.launch` -- spawn coordinator + N local
    worker processes;
  * ``python -m repro_torch.runtime.worker --coordinator HOST:PORT
    --worker-id I`` -- one worker role attaching to a remote coordinator;
  * :class:`repro_torch.runtime.chaos.ChaosController` -- kill / pause /
    resume / restart child workers under test control.

The framing (``protocol``) is also the serving plane's snapshot feed's
(``repro_torch.serving.remote``).
"""
from .protocol import (
    MAX_MESSAGE_BYTES, TRACE_FIELD, MessageSocket, attach_trace, connect_with_retry, recv_msg,
    recv_msg_sized, send_msg,
)
from .config import RuntimeConfig, owned_nodes
from .launch import ElasticResult, launch
from .replay import replay_scenario, simulate_reference

__all__ = [
    "RuntimeConfig", "owned_nodes", "launch", "ElasticResult", "replay_scenario",
    "simulate_reference",
    "send_msg", "recv_msg", "recv_msg_sized", "MessageSocket", "connect_with_retry",
    "TRACE_FIELD", "attach_trace", "MAX_MESSAGE_BYTES",
]
