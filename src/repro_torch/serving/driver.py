"""Request driving: prefill by decode steps, and continuous batching over
``Model.decode_step``.

Counterpart of ``repro.serving.driver``:

  * :func:`scan_prefill` -- a prompt prefilled token by token through
    ``decode_step`` into the ring-buffer caches (the reference's
    ``lax.scan`` over decode steps is a Python loop; each step is the same
    per-token computation, so the last logits and the caches are what the
    sequential decode calls give);
  * :class:`RequestDriver` -- a fixed set of decode slots; every step
    advances all slots by one token (prompt tokens are teacher-forced
    through the same decode path), a finished request frees its slot, and a
    queued request is admitted into a freed slot whose cache lanes are reset
    to their empty values, whatever the cache holds (ring-buffer ``pos`` to
    -1, an RWKV-6 state and token shifts to zero).

On a mesh-sharded serve job (``job=``) each data rank drives its own
slots against its cache shards, and the data ranks step together, as one
driver over the whole batch's slots would (a MoE queues them as one).
Greedy only, as the reference's driver.  With a telemetry hub each step
runs in fenced ``serve/admit`` and ``serve/decode`` spans (the host copy
of the sampled tokens fences the decode span), and with a
``ServingMetrics`` each ``run`` lands in its ``requests_per_sec`` and
``tokens_per_sec`` streams.  Everything runs under
``torch.inference_mode()``.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device, synchronize
from ..telemetry.spans import span
from ..tree import tree_map

Tree = Any

__all__ = ["scan_prefill", "RequestDriver"]


@torch.inference_mode()
def scan_prefill(model, params, caches, prompts: torch.Tensor, *, start_pos: int = 0,
                 dtype=torch.float32):
    """Prefill ``prompts`` (B, T) by T decode steps from ``caches``.

    Returns ``(logits, caches)``: the logits of the LAST prompt token and
    the populated caches."""
    b, t = prompts.shape
    logits = None
    for i in range(t):
        pos = torch.full((b,), start_pos + i, dtype=torch.int32, device=prompts.device)
        logits, caches = model.decode_step(params, caches, prompts[:, i:i + 1], pos,
                                           dtype=dtype)
    return logits, caches


class RequestDriver:
    """Continuous batching over ``Model.decode_step``.

    model:     a ``repro_torch.models.Model`` with a decode path
               (``head == "lm"``).
    slots:     decode batch width -- concurrent requests in flight.
    max_len:   cache capacity (longest prompt + generation).
    decode_fn: optional ``(params, caches, tokens, position) -> (logits,
               caches)`` (e.g. a ``ServeJob.decode_fn``); defaults to the
               model's ``decode_step`` in ``dtype``.
    telemetry: optional ``repro_torch.telemetry.Telemetry`` hub: fenced
               ``serve/admit`` and ``serve/decode`` spans per step (the
               metrics' hub when only ``metrics`` is given).
    metrics:   optional ``repro_torch.serving.ServingMetrics``: each
               ``run`` records its requests and tokens per second.
    device:    where the caches live: CUDA unless the CPU is asked for.
    job:       optional ``launch.serve.ServeJob`` on a mesh: the cache
               template is its ``init_cache(slots, max_len)``, this rank's
               shard, and ``decode_fn`` defaults to its ``decode_fn`` (a
               ``decode_fn`` given beside a job takes its ``global_batch``
               keyword), so that the driver runs against the rank's shard
               on the job's device.  ``slots`` is then the whole batch's:
               this data rank drives its own of them (``job.rows(slots)``),
               with the requests submitted to it; every model rank of a
               data rank is given the same requests.  Where the slots are
               split over the data ranks, ``run`` steps until no data rank
               has a request left (a rank with none steps its empty
               slots); a caller of ``step`` keeps the ranks in step too.
    """

    def __init__(self, model, *, slots: int, max_len: int, dtype=torch.float32,
                 decode_fn=None, telemetry=None, metrics=None, device=None, job=None):
        if model.cfg.head != "lm":
            raise ValueError(f"{model.cfg.name} has no decode path")
        self.model = model
        self.max_len = int(max_len)
        self.dtype = dtype
        self.metrics = metrics
        self.telemetry = telemetry or (metrics.telemetry if metrics is not None else None)
        self._data = None       # the mesh whose data ranks split the slots
        if job is None:
            self.slots = int(slots)
            self.device = resolve_device(device)
            self._cache_template = model.init_cache(self.slots, self.max_len, dtype=dtype,
                                                    device=self.device)
        else:
            whole = int(slots)
            rows = job.rows(whole)
            self.slots = rows.stop - rows.start
            self.device = job.device
            self._cache_template = job.init_cache(whole, self.max_len, dtype=dtype)
            if self.slots != whole:
                self._data = job.mesh
            decode = decode_fn or job.decode_fn

            def decode_fn(p, c, t, pos):
                return decode(p, c, t, pos, global_batch=whole)
        self._decode = decode_fn or (
            lambda p, c, t, pos: model.decode_step(p, c, t, pos, dtype=dtype)
        )
        self.reset()

    @torch.inference_mode()
    def _step(self, params, caches, tokens, position):
        logits, caches = self._decode(params, caches, tokens, position)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), caches

    @torch.inference_mode()
    def _reset_slot(self, caches, slot: int):
        """Restore one slot's cache lanes to their empty values, in place
        on the driver's own caches."""
        def reset(c, t):
            c[:, slot] = t[:, 0]
            return c

        return tree_map(reset, caches, self._cache_template)

    # ------------------------------------------------------------------
    def reset(self):
        self.caches = tree_map(torch.clone, self._cache_template)
        self._active: List[Optional[dict]] = [None] * self.slots
        self._queue: deque = deque()
        self._next_id = 0
        self.results: Dict[int, np.ndarray] = {}
        self.steps = 0

    def submit(self, prompt: Sequence[int], new_tokens: int) -> int:
        """Queue one request; returns its id (results land in
        ``self.results[id]`` once the request completes)."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token sequence")
        if prompt.size + int(new_tokens) > self.max_len:
            raise ValueError(
                f"prompt({prompt.size}) + new_tokens({new_tokens}) exceeds "
                f"max_len={self.max_len}"
            )
        rid = self._next_id
        self._next_id += 1
        self._queue.append({
            "id": rid, "prompt": prompt, "plen": int(prompt.size),
            "new": int(new_tokens), "pos": 0, "last": 0, "out": [],
        })
        return rid

    @property
    def pending(self) -> int:
        return len(self._queue) + sum(r is not None for r in self._active)

    def _pending_anywhere(self) -> int:
        """The requests left on this driver, or on every data rank where
        the slots are split over them."""
        if self._data is None:
            return self.pending
        return int(self._data.all_reduce_sum(torch.tensor([self.pending]))[0])

    # ------------------------------------------------------------------
    def _admit(self):
        for s in range(self.slots):
            if self._active[s] is None and self._queue:
                req = self._queue.popleft()
                self.caches = self._reset_slot(self.caches, s)
                self._active[s] = req

    def step(self, params: Tree) -> int:
        """Advance every in-flight request one token (one decode step);
        returns how many requests completed this step."""
        tel = self.telemetry
        with span(tel, "serve/admit", step=self.steps):
            self._admit()
        tokens = np.zeros((self.slots, 1), np.int32)
        position = np.zeros((self.slots,), np.int32)
        for s, req in enumerate(self._active):
            if req is None:
                continue
            tokens[s, 0] = (
                req["prompt"][req["pos"]] if req["pos"] < req["plen"] else req["last"]
            )
            position[s] = req["pos"]
        with span(tel, "serve/decode", step=self.steps):
            sampled, self.caches = self._step(
                params, self.caches, torch.from_numpy(tokens).to(self.device),
                torch.from_numpy(position).to(self.device))
            sampled = sampled.cpu().numpy()   # waits for the step: fences the span
        self.steps += 1

        done = 0
        for s, req in enumerate(self._active):
            if req is None:
                continue
            emitted = req["pos"] >= req["plen"] - 1   # past the prompt: greedy output
            req["pos"] += 1
            if emitted:
                req["last"] = int(sampled[s])
                req["out"].append(req["last"])
                if len(req["out"]) >= req["new"]:
                    self.results[req["id"]] = np.asarray(req["out"], np.int32)
                    self._active[s] = None
                    done += 1
        return done

    # ------------------------------------------------------------------
    def run(self, params: Tree, requests: Sequence[Tuple[Sequence[int], int]]) -> Dict[str, Any]:
        """Drive a workload to completion: submit all ``(prompt, new_tokens)``
        pairs, decode until every request finishes, return throughput stats."""
        ids = [self.submit(p, n) for p, n in requests]
        synchronize(self.device)
        t0 = time.perf_counter()
        completed = 0
        while self._pending_anywhere():
            completed += self.step(params)
        synchronize(self.device)
        elapsed = time.perf_counter() - t0
        tokens = int(sum(self.results[i].size for i in ids))
        if self.metrics is not None:
            self.metrics.record_requests(completed, tokens, elapsed)
        return {
            "completed": completed,
            "steps": self.steps,
            "elapsed_s": elapsed,
            "requests_per_sec": completed / max(elapsed, 1e-9),
            "tokens_per_sec": tokens / max(elapsed, 1e-9),
            "outputs": {i: self.results[i] for i in ids},
        }
