"""Coordinator role: membership, round issue/collect, canonical state, resync.

Counterpart of ``repro.runtime.coordinator``, with the same logic.  It does
no device work: canonical leaves are host numpy arrays, its
:class:`~repro_torch.checkpoint.ResyncStore` loads onto the CPU, and the
loaded tensors turn back into the wire arrays the workers sent.

The coordinator owns four things and NO tensor computation:

  * the :class:`~repro_torch.runtime.group.ProcessGroup` — live membership with
    heartbeat liveness and a fencing epoch;
  * the BASE schedule — the fault-free materialization of the configured
    topology (identical rng consumption to the replay scenario), onto which
    live membership is layered per round: ``active = base_active & alive``,
    then the same ``renormalize_dropout`` rewrite the Dropout fault model
    applies, so the live run and a :class:`RecordedFaults` replay of its
    ``active_log`` materialize bitwise the same W_t / mask arrays;
  * the CANONICAL state — wire leaves of the full post-round algorithm
    state (owner rows from each live worker's DONE, frozen previous rows
    for dead nodes, scalars from the lowest live worker), saved to the
    :class:`~repro_torch.checkpoint.ResyncStore` after every round.  Rejoins are
    served from the bundle on disk, never from memory;
  * run telemetry — the runtime streams (membership epoch, live worker
    count, heartbeat ages, round/resync wall time) in its own hub, plus
    every worker's drained records, merged into one coordinator-side
    run-stamped JSONL when ``stream_path`` is set.

Failure handling is epoch-fenced re-issue: if a worker dies (socket EOF) or
stalls past the heartbeat timeout mid-round, the survivors' in-flight round
is abandoned (their uncommitted state is discarded by the re-issued ROUND),
membership is rewritten, the epoch bumps, and the SAME round restarts with
the shrunken active mask — deterministic because workers recompute from
their committed start-of-round state.
"""
from __future__ import annotations

import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..checkpoint import ResyncStore
from ..checkpoint.checkpoint import _to_numpy
from ..core import make_algorithm
from ..scenarios import Scenario, renormalize_dropout
from ..telemetry import (
    DiagnosticsMonitor, JsonlWriter, RecordCursor, Telemetry, TraceRecorder,
    new_run_id, register_runtime_streams, round_trace_id, run_metadata,
    trace_events, write_chrome_trace,
)
from .chaos import ChaosController, ChaosEvent, by_round
from .config import RuntimeConfig, owned_nodes
from .engine import packed_transport
from .group import ProcessGroup
from .protocol import attach_trace

__all__ = ["Coordinator", "CoordinatorResult", "base_scenario"]

_JOIN_TIMEOUT_S = 180.0


def base_scenario(config: RuntimeConfig) -> Scenario:
    """The fault-free base: the ONLY scenario rng consumer is the topology
    generator, exactly as in the replay scenario (RecordedFaults consumes no
    rng), so live and replayed schedules agree bitwise."""
    return Scenario(name="elastic_base", topology=config.topology,
                    seed=config.seed)


class CoordinatorResult:
    """What a completed run hands back to ``launch``."""

    def __init__(self):
        self.final_leaves: List[np.ndarray] = []
        self.final_key: Optional[np.ndarray] = None
        self.active_log: Optional[np.ndarray] = None
        self.epochs: List[int] = []
        self.resync_seconds: List[float] = []
        self.round_seconds: List[float] = []
        self.startup_seconds: float = 0.0
        self.join_seconds: List[float] = []
        self.worker_records: List[dict] = []
        self.wall_s: float = 0.0
        self.trace_path: Optional[str] = None
        self.diagnostics: Optional[Dict[str, Any]] = None
        self.socket_bytes: Optional[Dict[str, int]] = None


class Coordinator:
    def __init__(
        self,
        config: RuntimeConfig,
        n_workers: int,
        group: ProcessGroup,
        controller: Optional[ChaosController] = None,
        plan: Sequence[ChaosEvent] = (),
        stream_path: Optional[str] = None,
        resync_dir: Optional[str] = None,
        trace_path: Optional[str] = None,
    ):
        self.cfg = config
        self.n_workers = int(n_workers)
        self.group = group
        self.controller = controller
        self.actions = by_round(plan)
        self.trace_path = trace_path

        self.hub = Telemetry(
            config=config.to_config(), spans=False,
            meta=run_metadata(config.to_config(), process="coordinator"),
        )
        register_runtime_streams(self.hub)
        self.writer = (
            JsonlWriter(stream_path, self.hub.meta) if stream_path else None
        )
        # causal tracing + convergence watching + the /healthz snapshot:
        # the run id prefixes every round's trace id; the coordinator's own
        # spans/instants drain through a PERSISTENT cursor (so the trace
        # file and the JSONL stream each see every record exactly once) and
        # every drained record — ours and the workers' — is retained in
        # ``_records`` for stitching.  ``obs_lock`` guards all of it against
        # the FleetServer's probe threads.
        self.run_id = new_run_id()
        self.tracer = TraceRecorder(self.hub)
        self.diag = DiagnosticsMonitor(self.hub)
        self.obs_lock = threading.RLock()
        self._cursor = RecordCursor(self.hub)
        self._records: List[dict] = []
        self._cur_trace: Optional[str] = None
        self._round_now = 0
        self.store = ResyncStore(
            resync_dir or tempfile.mkdtemp(prefix="repro-resync-"), device="cpu"
        )
        self.owned = [
            owned_nodes(config.n_nodes, self.n_workers, w)
            for w in range(self.n_workers)
        ]
        alg = make_algorithm(config.algorithm, **config.hyperparams)
        self.round_len = alg.comm.round_len(getattr(alg, "tau", 1))
        self.schedule = base_scenario(config).materialize(
            config.n_nodes, config.n_rounds, self.round_len, config.batch_size
        )
        # packed (wire-true) transport: rounds broadcast the canonical
        # encoded payload and collect packed owned rows — no dense
        # contrib/gather.  Derived from the config alone, so every worker
        # reaches the same verdict from its WELCOME copy.
        self.packed = (
            config.packed_transport != "off" and packed_transport(alg)
        )

        self.stacked_mask: Optional[List[bool]] = None
        self.canonical: Optional[List[np.ndarray]] = None
        self.canonical_key: Optional[np.ndarray] = None
        self.fly_mask: Optional[List[bool]] = None
        self.canonical_fly: Optional[List[np.ndarray]] = None
        self._fly_idx: List[int] = []
        self._canonical_round = 0   # the round self.canonical reflects
        self._saved_round = -1      # the round the resync store holds
        self._last_socket_bytes = 0
        self.result = CoordinatorResult()
        self._pending_joins: List[Tuple[int, bool, Any]] = []
        self._spawned_at: Dict[int, float] = {}   # rejoins: respawn times
        self._sleep_map: Dict[int, float] = {}

    # -- event plumbing -------------------------------------------------
    def _epoch_instant(self, reason: str, wid: int) -> None:
        """Mark a membership-epoch transition on the coordinator's trace
        track (and feed the fault context to the diagnostics monitor)."""
        with self.obs_lock:
            self.tracer.instant(
                "epoch_bump", trace=self._cur_trace, step=self._round_now,
                worker=wid, reason=reason, to_epoch=self.group.epoch,
            )

    def _handle_background(self, evt) -> None:
        """hello -> queue for the next boundary; eof -> membership rewrite."""
        kind = evt[0]
        if kind == "hello":
            self._pending_joins.append(evt[1:])
        elif kind == "eof":
            self.group.mark_dead(evt[1])
            self._epoch_instant("eof", evt[1])
        # stray msgs between rounds are stale echoes: drop

    def _wait_msg(self, wid: int, want: str, timeout_s: float) -> dict:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            evt = self.group.next_event(timeout=0.5)
            if evt is None:
                continue
            if evt[0] == "msg" and evt[1] == wid and evt[2].get("type") == want:
                return evt[2]
            if evt[0] == "eof" and evt[1] == wid:
                self.group.mark_dead(wid)
                self._epoch_instant("eof", wid)
                raise RuntimeError(f"worker {wid} died awaiting {want!r}")
            self._handle_background(evt)
        raise TimeoutError(f"worker {wid}: no {want!r} within {timeout_s:.0f}s")

    def _wait_hello(self, wid: int, timeout_s: float) -> None:
        if any(j[0] == wid for j in self._pending_joins):
            return
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            evt = self.group.next_event(timeout=0.5)
            if evt is None:
                continue
            self._handle_background(evt)
            if evt[0] == "hello" and evt[1] == wid:
                return
        raise TimeoutError(f"worker {wid}: no hello within {timeout_s:.0f}s")

    def _await_death(self, wid: int, timeout_s: float = 30.0) -> None:
        deadline = time.monotonic() + timeout_s
        while wid in self.group.handles:
            if time.monotonic() > deadline:
                raise TimeoutError(f"worker {wid}: no EOF after kill")
            evt = self.group.next_event(timeout=0.5)
            if evt is not None:
                self._handle_background(evt)

    # -- membership -----------------------------------------------------
    def _welcome(self, wid: int, conn, round_: int, need_init: bool) -> None:
        self.group.attach(wid, conn)
        self.group.send(wid, {
            "type": "welcome", "config": self.cfg, "n_workers": self.n_workers,
            "round": round_, "epoch": self.group.epoch, "need_init": need_init,
        })

    def _ensure_snapshot(self, round_: int) -> None:
        """Make sure the resync store holds a bundle for ``round_``.

        The dense protocol saves every round, so this is a no-op there.  The
        packed protocol only refreshes the canonical state on snapshot
        rounds; a join/recovery at any other boundary triggers this one
        extra SNAPSHOT round-trip — workers ship owned rows + scalars of
        their committed state and the coordinator folds them over the last
        canonical (rows owned by dead workers keep their last-snapshot
        values, the same freezing rule the snapshot rounds apply)."""
        if self._saved_round == round_:
            return
        while True:
            live = self.group.live()
            if not live:
                raise RuntimeError(f"snapshot at round {round_}: no live workers")
            ep = self.group.epoch
            for wid in live:
                self.group.send(wid, {
                    "type": "snapshot", "round": round_, "epoch": ep,
                })
            rows = self._collect("snapshot_rows", round_, ep, live)
            if rows is not None:
                break
        lead = min(rows)
        stacked_idx = [i for i, m in enumerate(self.stacked_mask) if m]
        scalar_idx = [i for i, m in enumerate(self.stacked_mask) if not m]
        new = [np.array(l, copy=True) for l in self.canonical]
        for wid in live:
            rrows = self.owned[wid]
            for j, i in enumerate(stacked_idx):
                new[i][rrows] = np.asarray(rows[wid]["state_rows"][j])
        for j, i in enumerate(scalar_idx):
            new[i] = np.asarray(rows[lead]["scalar_leaves"][j])
        if self.canonical_fly is not None:
            for j, i in enumerate(self._fly_idx):
                new[i] = np.array(self.canonical_fly[j], copy=True)
        self.canonical = new
        self.canonical_key = np.asarray(rows[lead]["key"])
        self._canonical_round = round_
        self.store.save(round_, self.canonical, self.canonical_key,
                        {"epoch": self.group.epoch})
        self._saved_round = round_

    def _resync(self, wid: int, round_: int) -> None:
        """Serve the canonical bundle FROM DISK and wait for the ack."""
        self._ensure_snapshot(round_)
        trace = round_trace_id(self.run_id, round_)
        t0 = time.perf_counter()
        with self.tracer.span("resync", trace=trace, step=round_,
                              epoch=self.group.epoch) as info:
            info["worker"] = wid
            leaves, key_data, loaded_round, _meta = self.store.load()
            leaves, key_data = [_to_numpy(l) for l in leaves], _to_numpy(key_data)
            if loaded_round != round_:
                raise RuntimeError(
                    f"resync bundle is for round {loaded_round}, need {round_}"
                )
            self.group.send(wid, attach_trace({
                "type": "resync", "leaves": leaves, "key": key_data,
                "round": round_, "epoch": self.group.epoch,
            }, trace))
            self._wait_msg(wid, "resync_ok", _JOIN_TIMEOUT_S)
        dt = time.perf_counter() - t0
        self.result.resync_seconds.append(dt)
        self.hub.record("resync_seconds", dt, step=round_)

    def _process_joins(self, round_: int) -> None:
        """Round-boundary membership admission: resumed workers resync in
        place; fresh sockets (rejoins) get welcome -> ready -> resync."""
        for wid in self.group.recovered():
            self._resync(wid, round_)
            self.group.unsuspend(wid)
            self._epoch_instant("recovered", wid)
        while self._pending_joins:
            wid, _rejoin, conn = self._pending_joins.pop(0)
            self._welcome(wid, conn, round_, need_init=False)
            self._wait_msg(wid, "ready", _JOIN_TIMEOUT_S)
            self._resync(wid, round_)
            self.group.bump_epoch()
            self._epoch_instant("rejoin", wid)
            if wid in self._spawned_at:
                self.result.join_seconds.append(
                    time.perf_counter() - self._spawned_at.pop(wid))

    def _apply_chaos(self, round_: int) -> None:
        for ev in self.actions.get(round_, ()):
            if self.controller is None:
                raise RuntimeError("chaos plan given but no controller")
            if ev.action == "kill":
                self.controller.kill(ev.worker)
                self._await_death(ev.worker)
            elif ev.action == "rejoin":
                self._spawned_at[ev.worker] = time.perf_counter()
                self.controller.spawn(ev.worker)
                self._wait_hello(ev.worker, _JOIN_TIMEOUT_S)
            elif ev.action == "sleep":
                self._sleep_map[ev.worker] = float(ev.seconds)
            elif ev.action == "pause":
                self.controller.pause(ev.worker)
            elif ev.action == "resume":
                self.controller.resume(ev.worker)
                # wait for the first post-SIGCONT heartbeat so the boundary
                # re-admission (`_process_joins`) lands at THIS round
                deadline = time.monotonic() + 30.0
                while (ev.worker not in self.group.recovered()
                       and time.monotonic() < deadline):
                    evt = self.group.next_event(timeout=0.25)
                    if evt is not None:
                        self._handle_background(evt)

    # -- startup --------------------------------------------------------
    def _startup(self) -> None:
        deadline = time.monotonic() + _JOIN_TIMEOUT_S
        readys: Dict[int, dict] = {}
        while len(readys) < self.n_workers:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"only {sorted(readys)} of {self.n_workers} workers ready"
                )
            evt = self.group.next_event(timeout=0.5)
            if evt is None:
                continue
            kind = evt[0]
            if kind == "hello":
                wid, _rejoin, conn = evt[1:]
                self._welcome(wid, conn, 0, need_init=(wid == 0))
            elif kind == "msg" and evt[2].get("type") == "ready":
                readys[evt[1]] = evt[2]
            elif kind == "eof":
                raise RuntimeError(f"worker {evt[1]} died during startup")
        masks = {tuple(m["stacked_mask"]) for m in readys.values()}
        if len(masks) != 1:
            raise RuntimeError(f"workers disagree on stacked leaves: {masks}")
        self.stacked_mask = list(masks.pop())
        fly = {tuple(m.get("fly_mask", ())) for m in readys.values()}
        if len(fly) != 1:
            raise RuntimeError(f"workers disagree on fly leaves: {fly}")
        self.fly_mask = list(fly.pop())
        self._fly_idx = [i for i, m in enumerate(self.fly_mask) if m]
        init = readys[0]
        self.canonical = [np.asarray(l) for l in init["leaves"]]
        self.canonical_key = np.asarray(init["key"])
        if self.packed:
            if not self._fly_idx:
                raise RuntimeError(
                    "packed transport selected but the state has no fly "
                    "(in-flight payload) leaves"
                )
            self.canonical_fly = [
                np.array(self.canonical[i], copy=True) for i in self._fly_idx
            ]
        self.store.save(0, self.canonical, self.canonical_key,
                        {"epoch": self.group.epoch})
        self._saved_round = 0

    # -- the round ------------------------------------------------------
    def _collect(self, want: str, round_: int, epoch: int,
                 live: Sequence[int]) -> Optional[Dict[int, dict]]:
        """All live workers' ``want`` messages for (round, epoch), or None
        when membership changed underneath (caller re-issues the round)."""
        got: Dict[int, dict] = {}
        waiting = set(live)
        while waiting:
            evt = self.group.next_event(timeout=0.25)
            if evt is None:
                stale = self.group.stale()
                if stale:
                    for wid in stale:
                        self.group.mark_suspended(wid)
                        self._epoch_instant("heartbeat_stale", wid)
                    return None
                continue
            kind = evt[0]
            if kind == "hello":
                self._pending_joins.append(evt[1:])
                continue
            if kind == "eof":
                wid = evt[1]
                self.group.mark_dead(wid)
                self._epoch_instant("eof", wid)
                if wid in waiting or wid in got:
                    return None
                continue
            _, wid, msg = evt
            if (msg.get("type") == want
                    and int(msg.get("round", -1)) == round_
                    and int(msg.get("epoch", -1)) == epoch
                    and wid in waiting):
                got[wid] = msg
                waiting.discard(wid)
            # everything else: stale echoes from a previous epoch
        return got

    def _assemble(self, live: Sequence[int], contribs: Dict[int, dict]):
        """Full stacked state arrays (canonical rows overwritten by owner
        rows) + the full last batch (non-owned rows zero)."""
        stacked_idx = [i for i, m in enumerate(self.stacked_mask) if m]
        state_full = [
            np.array(self.canonical[i], copy=True) for i in stacked_idx
        ]
        for wid in live:
            rows = self.owned[wid]
            for j, arr in enumerate(contribs[wid]["state_rows"]):
                state_full[j][rows] = np.asarray(arr)
        bx0, by0 = contribs[live[0]]["batch_rows"]
        n = self.cfg.n_nodes
        x_full = np.zeros((n,) + bx0.shape[1:], dtype=bx0.dtype)
        y_full = np.zeros((n,) + by0.shape[1:], dtype=by0.dtype)
        for wid in live:
            rows = self.owned[wid]
            cbx, cby = contribs[wid]["batch_rows"]
            x_full[rows] = cbx
            y_full[rows] = cby
        return state_full, (x_full, y_full)

    def _node_alive(self, live: Sequence[int]) -> np.ndarray:
        mask = np.zeros(self.cfg.n_nodes, dtype=bool)
        for wid in live:
            mask[self.owned[wid]] = True
        return mask

    def _try_round(self, r: int) -> bool:
        with self.tracer.span("round", trace=self._cur_trace, step=r,
                              epoch=self.group.epoch) as span_info:
            ok = self._try_round_inner(r)
            if not ok:
                # the attempt is abandoned (membership changed mid-round);
                # the SAME trace id will carry the re-issued attempt
                span_info["abandoned"] = True
        return ok

    def _try_round_inner(self, r: int) -> bool:
        live = self.group.live()
        if not live:
            raise RuntimeError(f"round {r}: no live workers")
        active = self.schedule.active[r] & self._node_alive(live)
        if not active.any():
            raise RuntimeError(f"round {r}: no active nodes")
        # the SAME rewrite Dropout/RecordedFaults apply — f64 renormalize,
        # f32 store — so the replay reproduces this W_t bitwise
        w_r = renormalize_dropout(
            self.schedule.w[r].astype(np.float64), active
        ).astype(np.float32)
        lm_r = self.schedule.local_mask[r] & active[None, :]
        ep = self.group.epoch
        base_msg = {
            "type": "round", "round": r, "epoch": ep,
            "w": w_r, "active": active, "local_mask": lm_r,
            "pattern": int(self.schedule.pattern[r]),
            "comp_scale": (
                None if self.schedule.comp_scale is None
                else self.schedule.comp_scale[r]
            ),
            "trigger": (
                None if self.schedule.trigger is None
                else self.schedule.trigger[r]
            ),
        }
        if self.packed:
            return self._packed_round(r, ep, live, active, base_msg)
        for wid in live:
            self.group.send(wid, attach_trace(
                dict(base_msg, sleep=self._sleep_map.get(wid, 0.0)),
                self._cur_trace))
        contribs = self._collect("contrib", r, ep, live)
        if contribs is None:
            return False
        state_full, batch_full = self._assemble(live, contribs)
        for wid in live:
            self.group.send(wid, attach_trace({
                "type": "gather", "round": r, "epoch": ep,
                "state": state_full, "batch": batch_full,
            }, self._cur_trace))
        dones = self._collect("done", r, ep, live)
        if dones is None:
            return False
        self._sleep_map.clear()

        # canonical: lead worker's full leaves, owner rows overwritten,
        # inactive rows frozen from the previous canonical
        lead = min(dones)
        stacked_idx = [i for i, m in enumerate(self.stacked_mask) if m]
        new = [np.array(np.asarray(l), copy=True) for l in dones[lead]["leaves"]]
        for wid in live:
            rows = self.owned[wid]
            for i in stacked_idx:
                new[i][rows] = np.asarray(dones[wid]["leaves"][i])[rows]
        inactive = ~active
        if inactive.any():
            for i in stacked_idx:
                new[i][inactive] = self.canonical[i][inactive]
        self.canonical = new
        self.canonical_key = np.asarray(dones[lead]["key"])
        self._canonical_round = r + 1
        self.result.active_log[r] = active
        self._merge_done_records(dones)
        return True

    def _packed_round(self, r: int, ep: int, live: Sequence[int],
                      active: np.ndarray, base_msg: dict) -> bool:
        """One wire-true round: broadcast the canonical in-flight payload
        (the ONLY cross-worker state the round needs — every worker evolves
        the full wire trees identically from it), collect packed owned
        payload rows back, and only reassemble the dense canonical state on
        snapshot rounds.  The dense contrib/gather exchange never happens."""
        full = ((r + 1) % max(1, self.cfg.snapshot_every) == 0
                or r == self.cfg.n_rounds - 1)
        for wid in live:
            self.group.send(wid, attach_trace(
                dict(base_msg, payload=self.canonical_fly, full=full,
                     sleep=self._sleep_map.get(wid, 0.0)),
                self._cur_trace))
        dones = self._collect("done", r, ep, live)
        if dones is None:
            return False
        self._sleep_map.clear()

        # next round's broadcast payload: owner rows from each live worker,
        # dead-owner rows frozen (they are gated by ``active`` everywhere)
        new_fly = [np.array(a, copy=True) for a in self.canonical_fly]
        for wid in live:
            rows = self.owned[wid]
            for j, arr in enumerate(dones[wid]["fly_rows"]):
                new_fly[j][rows] = np.asarray(arr)
        self.canonical_fly = new_fly
        lead = min(dones)
        self.canonical_key = np.asarray(dones[lead]["key"])
        if full:
            stacked_idx = [i for i, m in enumerate(self.stacked_mask) if m]
            scalar_idx = [i for i, m in enumerate(self.stacked_mask) if not m]
            new = [np.array(l, copy=True) for l in self.canonical]
            for wid in live:
                rows = self.owned[wid]
                for j, i in enumerate(stacked_idx):
                    new[i][rows] = np.asarray(dones[wid]["state_rows"][j])
            for j, i in enumerate(scalar_idx):
                new[i] = np.asarray(dones[lead]["scalar_leaves"][j])
            for j, i in enumerate(self._fly_idx):
                new[i] = np.array(new_fly[j], copy=True)
            self.canonical = new
            self._canonical_round = r + 1
        self.result.active_log[r] = active
        self._merge_done_records(dones)
        return True

    def _merge_done_records(self, dones: Dict[int, dict]) -> None:
        for wid in sorted(dones):
            recs = dones[wid].get("records") or []
            self.result.worker_records.extend(recs)
            with self.obs_lock:
                self._records.extend(recs)
            if self.writer is not None:
                self.writer.append(recs)

    def _consensus_error(self, active: np.ndarray) -> Optional[float]:
        """Host-side ``||X - X̄||²`` over the canonical stacked leaves,
        restricted to active nodes — the coordinator's own view of the
        paper's consensus quantity, cheap enough to compute every round
        (the leaves are already on the host for the resync bundle)."""
        if self.canonical is None or not active.any():
            return None
        total = 0.0
        for leaf, stacked in zip(self.canonical, self.stacked_mask):
            if not stacked:
                continue
            rows = np.asarray(leaf, dtype=np.float64)[active]
            total += float(((rows - rows.mean(axis=0)) ** 2).sum())
        return total

    # -- live observability (FleetServer probe callbacks; all take the
    # obs_lock so the HTTP threads never race the run loop) --------------
    def health(self) -> Dict[str, Any]:
        """The ``/healthz`` payload: membership + round progress."""
        with self.obs_lock:
            snap = self.group.health()
            snap.update({
                "run_id": self.run_id,
                "round": self._round_now,
                "n_rounds": self.cfg.n_rounds,
                "n_workers": self.n_workers,
            })
            snap["ok"] = not snap["dead"] and not snap["suspended"]
            return snap

    def metrics_text(self) -> str:
        """The ``/metrics`` payload: the coordinator hub's Prometheus
        exposition (round/resync timing, membership, anomalies, spans)."""
        with self.obs_lock:
            return self.hub.prometheus()

    def recent_trace(self, limit: int = 2000) -> List[dict]:
        """The ``/trace`` payload: the last ``limit`` drained records,
        stitched into Chrome trace events."""
        with self.obs_lock:
            return trace_events(self._records[-limit:])

    def diagnose(self) -> Dict[str, Any]:
        with self.obs_lock:
            return self.diag.diagnose()

    def _observe_round(self, r: int, dt: float) -> None:
        """Post-round bookkeeping: runtime streams, the diagnostics feed
        (host-side consensus over the canonical leaves + membership), and
        the per-round drain of the coordinator's own records."""
        with self.obs_lock:
            self.hub.record("round_seconds", dt, step=r)
            self.hub.record("membership_epoch", self.group.epoch, step=r)
            self.hub.record("active_workers", len(self.group.live()), step=r)
            for wid, age in self.group.heartbeat_ages().items():
                self.hub.record("heartbeat_age", age, step=r,
                                label=f"worker:{wid}")
            sb = self.group.socket_bytes()
            self.hub.record("socket_round_bytes",
                            sb["total"] - self._last_socket_bytes, step=r)
            self._last_socket_bytes = sb["total"]
            # packed rounds between snapshots leave self.canonical stale —
            # only feed the consensus watcher a value it can trust
            consensus = (
                self._consensus_error(self.result.active_log[r])
                if self._canonical_round == r + 1 else None
            )
            self.diag.observe(r, epoch=self.group.epoch, consensus=consensus)
            chunk = self._cursor.drain()
            self._records.extend(chunk)
            if self.writer is not None:
                self.writer.append(chunk)
            self._round_now = r + 1

    # -- entry ----------------------------------------------------------
    def run(self) -> CoordinatorResult:
        t_start = time.perf_counter()
        self.result.active_log = np.ones(
            (self.cfg.n_rounds, self.cfg.n_nodes), dtype=bool
        )
        self._startup()
        self.result.startup_seconds = time.perf_counter() - t_start
        for r in range(self.cfg.n_rounds):
            self._cur_trace = round_trace_id(self.run_id, r)
            self._apply_chaos(r)
            self._process_joins(r)
            t_round = time.perf_counter()
            while not self._try_round(r):
                # membership changed mid-round: admit recoveries, re-issue
                self._process_joins(r)
            dt = time.perf_counter() - t_round
            self.result.round_seconds.append(dt)
            self.result.epochs.append(self.group.epoch)
            self._observe_round(r, dt)
            if self._canonical_round == r + 1:
                self.store.save(r + 1, self.canonical, self.canonical_key,
                                {"epoch": self.group.epoch})
                self._saved_round = r + 1
        for wid in self.group.live():
            self.group.send(wid, {"type": "shutdown"})
        with self.obs_lock:
            chunk = self._cursor.drain()
            self._records.extend(chunk)
            if self.writer is not None:
                self.writer.append(chunk)
                self.writer.close()
            self.result.diagnostics = self.diag.diagnose()
            if self.trace_path is not None:
                # _records already holds the workers' drained records (they
                # were folded in per-DONE), so this is the whole fleet
                write_chrome_trace(self.trace_path, self._records)
                self.result.trace_path = self.trace_path
        self.result.final_leaves = self.canonical
        self.result.final_key = self.canonical_key
        self.result.socket_bytes = self.group.socket_bytes()
        self.result.wall_s = time.perf_counter() - t_start
        return self.result
