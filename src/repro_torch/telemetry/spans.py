"""Phase spans: fenced host-side timers and profiler ranges.

Counterpart of ``repro.telemetry.spans``.  PyTorch launches CUDA work
asynchronously, so an unfenced ``time.perf_counter()`` around a call times
its enqueueing, not its work.  A :func:`span` is the one honest timer: it
opens a ``torch.profiler.record_function("repro/<phase>")`` range (so the
phase shows in a trace captured with :func:`profile_trace`), hands the
caller a handle whose ``fence(obj)`` waits for the CUDA devices of the
phase's outputs, and records the fenced duration into the hub's
``span_seconds`` histogram (labeled by phase) plus a JSONL ``span`` event.

Usage::

    with span(hub, "gossip", step=r) as sp:
        state = comm_phase(state, last)
        sp.fence(state)

With ``hub`` None (or spans off on the hub) the context manager is a
complete no-op -- no range, no fence, no timing -- so uninstrumented paths
run exactly the operations they run without it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Iterator, Optional

import torch

__all__ = ["span", "profile_trace", "fence"]


def _cuda_devices(obj, found: set) -> set:
    """The CUDA devices of every tensor reachable in ``obj``: through dicts,
    tuples, lists and dataclasses (algorithm states, their ``ChannelState``
    wires and ``Packed`` payloads); other values hold none."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            found.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, found)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _cuda_devices(v, found)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _cuda_devices(getattr(obj, f.name), found)
    return found


def fence(obj) -> None:
    """Wait for the queued work of every CUDA device a tensor in ``obj``
    lives on; CPU tensors need no wait, and CUDA is never touched for them."""
    for dev in _cuda_devices(obj, set()):
        torch.cuda.synchronize(dev)


class _SpanHandle:
    """Handle yielded by :func:`span`; ``fence`` outputs before span close."""

    __slots__ = ("active",)

    def __init__(self, active: bool):
        self.active = active

    def fence(self, obj) -> None:
        if self.active:
            fence(obj)


_NULL_HANDLE = _SpanHandle(active=False)


@contextlib.contextmanager
def span(hub, phase: str, *, step: Optional[int] = None) -> Iterator[_SpanHandle]:
    """Time one phase, fenced; no-op when ``hub`` is None or spans are off."""
    if hub is None or not getattr(hub, "spans", False):
        yield _NULL_HANDLE
        return
    with torch.profiler.record_function(f"repro/{phase}"):
        t0 = time.perf_counter()
        yield _SpanHandle(active=True)
        dt = time.perf_counter() - t0
    hub.record("span_seconds", dt, step=step, label=phase)
    hub.record_event(
        {"event": "span", "phase": phase, "step": step, "seconds": dt}
    )


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """Bracket a block in ``torch.profiler.profile`` (CPU activity, and CUDA
    where a card is present) when ``trace_dir`` is set, and write its Chrome
    trace into ``trace_dir`` as ``trace_<pid>_<ns>.json``; a plain
    passthrough when it is None or empty."""
    if not trace_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
