"""Worker role: one OS process advancing its shard of the elastic run.

Counterpart of ``repro.runtime.worker``: the same message loop, re-entrant
commit and packed round.  Protocol (all over the coordinator's control
channel; every round-scoped message echoes the coordinator's membership
epoch so stale echoes after a mid-round re-issue are droppable):

    -> hello            announce (worker id, rejoin flag)
    <- welcome          RuntimeConfig + group size + starting round/epoch
    -> ready            stacked-leaf mask (+ init state leaves from worker 0)
    <- resync           canonical state + key (rejoin / in-place recovery)
    -> resync_ok
    <- round            W_t, active, local_mask + optional straggler sleep
    -> contrib          owned post-local state rows + owned last-batch rows
    <- gather           assembled full post-local state + full last batch
    -> done             full post-comm leaves + key + drained telemetry
    <- shutdown

The round protocol is RE-ENTRANT: a worker only commits round r's post-comm
state when it sees ROUND r+1, so when a death mid-round makes the
coordinator re-issue ROUND r under a new epoch, every surviving worker
recomputes r from its committed start-of-round state -- deterministically,
because the whole round is a pure function of (state, step, schedule row).

Three things differ from the reference:

  * the control socket has no read timeout once connected.  The dial keeps
    ``connect_with_retry``'s 10 s, but a worker then waits in ``recv`` for
    as long as the coordinator takes -- which, at a rejoin, is as long as
    the fresh process takes to start, build its engine and warm up;
  * before READY the worker runs one round of every op the run uses on a
    scratch copy of its state, so the kernels' first loads (Triton's cache,
    the nvcc-built libraries) land while the coordinator waits for READY,
    not inside a round, where they could starve the heartbeat thread past
    its timeout.  The launch counters are reset afterwards;
  * every DONE carries the kernel launches since the last one, folded into
    the worker's hub (``kernel_launches``, one label per op).

Run as ``python -m repro_torch.runtime.worker --coordinator HOST:PORT
--worker-id I`` (``repro_torch.runtime.launch`` spawns exactly this).  The
worker runs on ``config.device``; on the CPU it takes one torch thread.
"""
from __future__ import annotations

import argparse
import sys
import threading
import time
from typing import Optional

import numpy as np

from .config import RuntimeConfig
from .protocol import MessageSocket, connect_with_retry

__all__ = ["run_worker", "main"]


def _heartbeat_loop(conn: MessageSocket, worker_id: int, interval_s: float,
                    stop: threading.Event) -> None:
    while not stop.is_set():
        try:
            conn.send({"type": "heartbeat", "worker": worker_id, "t": time.time()})
        except OSError:
            return
        stop.wait(interval_s)


def warm_up(engine, state, key: int) -> None:
    """One round of the run's ops -- the local phase and the comm phase --
    on a scratch copy of ``state`` under a fault-free context, fenced.  The
    round is a pure function of its inputs, so nothing of it persists but
    the loaded kernels."""
    from ..device import synchronize
    from .engine import restore_wire_leaves, wire_leaves

    n, rl = engine.n_nodes, engine.round_len
    scratch = restore_wire_leaves(state, wire_leaves(state))
    lm = np.ones((max(rl - 1, 1), n), dtype=bool)
    post_local, k = engine.run_local(scratch, key, lm)
    k, last = engine.sample_comm_batch(k)
    engine.run_comm(post_local, last,
                    (np.eye(n, dtype=np.float32), np.ones(n, dtype=bool), lm, 0, None, None))
    synchronize(engine.device)


def run_worker(coordinator: str, worker_id: int, rejoin: bool = False) -> int:
    # torch import deferred past argparse so --help stays instant
    import torch

    from ..device import synchronize
    from ..kernels import api
    from ..telemetry import (
        RecordCursor, Telemetry, TraceRecorder, register_runtime_streams, run_metadata,
    )
    from .engine import WorkerEngine, packed_transport, restore_wire_leaves, wire_leaves

    conn = connect_with_retry(coordinator)
    stop = threading.Event()
    try:
        # the dial's 10 s must not become a timeout on every receive: a worker
        # idles in recv() for as long as the coordinator admits a rejoin
        conn.sock.settimeout(None)
        conn.send({"type": "hello", "worker": int(worker_id), "rejoin": bool(rejoin)})
        welcome = conn.recv()
        if not welcome or welcome.get("type") != "welcome":
            raise RuntimeError(f"expected welcome, got {welcome and welcome.get('type')}")
        cfg: RuntimeConfig = welcome["config"]
        n_workers = int(welcome["n_workers"])

        if torch.device(cfg.device).type == "cpu":
            torch.set_num_threads(1)
        engine = WorkerEngine(cfg, worker_id, n_workers)
        dev = engine.device
        hub = Telemetry(
            config=cfg.to_config(), spans=False,
            meta=run_metadata(cfg.to_config(), process=f"worker:{worker_id}"),
        )
        register_runtime_streams(hub)
        cursor = RecordCursor(hub)
        # span events (with their wall-clock anchors + the coordinator-minted
        # trace id off each round/resync message) ride the same cursor drain
        # in DONE messages -- the coordinator stitches them into one timeline
        tracer = TraceRecorder(hub)

        threading.Thread(
            target=_heartbeat_loop, args=(conn, worker_id, cfg.heartbeat_interval_s, stop),
            daemon=True, name="worker-heartbeat",
        ).start()

        state, key = engine.init_state()
        warm_up(engine, state, key)
        api.reset_counters()
        committed = (state, key)
        committed_round = int(welcome["round"])
        epoch = int(welcome["epoch"])
        packed = (cfg.packed_transport != "off") and packed_transport(engine.alg)

        ready = {
            "type": "ready", "worker": worker_id,
            "stacked_mask": engine.stacked_mask(state),
            "fly_mask": engine.fly_mask(state),
        }
        if welcome.get("need_init"):
            ready["leaves"] = wire_leaves(state)
            ready["key"] = np.array(key, np.int64)
        conn.send(ready)

        def drained(step: int) -> list:
            hub.record_kernel_launches(step=step)
            return cursor.drain()

        pending = None          # (state, key) awaiting commit
        pending_round = -1      # the round whose arrival commits it
        pushed: Optional[dict] = None
        while True:
            msg = pushed if pushed is not None else conn.recv()
            pushed = None
            if msg is None:
                return 1
            mtype = msg.get("type")
            if mtype == "shutdown":
                return 0
            if mtype == "resync":
                # adopt the canonical state wholesale (rejoin or in-place
                # recovery after a stall) -- template comes from our own
                # engine, only the leaf VALUES cross the wire
                with tracer.span("resync", trace=msg.get("trace"), step=int(msg["round"]),
                                 epoch=int(msg["epoch"])):
                    committed = (restore_wire_leaves(committed[0], msg["leaves"]),
                                 int(np.asarray(msg["key"])))
                    synchronize(dev)
                committed_round = int(msg["round"])
                epoch = int(msg["epoch"])
                pending = None
                conn.send({"type": "resync_ok", "worker": worker_id, "round": committed_round})
                continue
            if mtype == "snapshot":
                # packed-mode boundary snapshot: commit a matching pending
                # round, then ship owned rows + scalars of the committed
                # state so the coordinator can assemble a fresh resync bundle
                r = int(msg["round"])
                if pending is not None and r == pending_round:
                    committed = pending
                    committed_round = r
                    pending = None
                if committed_round != r:
                    raise RuntimeError(
                        f"snapshot for round {r} but committed state is at round "
                        f"{committed_round}")
                st, k = committed
                conn.send({
                    "type": "snapshot_rows", "worker": worker_id,
                    "round": r, "epoch": int(msg["epoch"]),
                    "state_rows": engine.owned_rows(st),
                    "scalar_leaves": engine.scalar_leaves(st),
                    "key": np.array(k, np.int64),
                })
                continue
            if mtype != "round":
                continue
            r, epoch = int(msg["round"]), int(msg["epoch"])
            if pending is not None and r == pending_round:
                committed = pending
                committed_round = r
            pending = None
            if r != committed_round:
                # a round we cannot serve from local state: the coordinator
                # resyncs stragglers explicitly, so just wait
                continue

            trace = msg.get("trace")
            sleep_s = float(msg.get("sleep") or 0.0)
            row = (msg["w"], msg["active"], msg["local_mask"], msg["pattern"],
                   msg.get("comp_scale"), msg.get("trigger"))
            t0 = time.perf_counter()
            if sleep_s:
                with tracer.span("straggler_sleep", trace=trace, step=r, epoch=epoch):
                    time.sleep(sleep_s)  # the REAL straggler
            st, k = committed
            if packed and "payload" in msg:
                # PACKED round: the broadcast canonical payload is the whole
                # cross-worker exchange -- overwrite the in-flight wire
                # message, run local + comm back to back (the comm phase's
                # only cross-row reads are the replica trees, which every
                # worker evolves identically from the same payloads), and
                # return packed owned payload rows instead of dense state
                st = engine.set_fly(st, msg["payload"])
                with tracer.span("local", trace=trace, step=r, epoch=epoch):
                    post_local, k = engine.run_local(st, k, np.asarray(msg["local_mask"]))
                    k, last = engine.sample_comm_batch(k)
                with tracer.span("gossip", trace=trace, step=r, epoch=epoch):
                    post_comm = engine.run_comm(post_local, last, row)
                    synchronize(dev)
                pending = (post_comm, k)
                pending_round = r + 1
                dt = time.perf_counter() - t0
                hub.record("contrib_seconds", dt, step=r)
                done = {
                    "type": "done", "worker": worker_id, "round": r, "epoch": epoch,
                    "fly_rows": engine.fly_rows(post_comm),
                    "key": np.array(k, np.int64),
                    "seconds": dt,
                }
                if msg.get("full"):
                    done["state_rows"] = engine.owned_rows(post_comm)
                    done["scalar_leaves"] = engine.scalar_leaves(post_comm)
                done["records"] = drained(r)
                conn.send(done)
                continue
            with tracer.span("local", trace=trace, step=r, epoch=epoch):
                post_local, k = engine.run_local(st, k, np.asarray(msg["local_mask"]))
                k, last = engine.sample_comm_batch(k)
                state_rows = engine.owned_rows(post_local)  # host copies fence the device
                batch_rows = engine.owned_batch(last)
            contrib_s = time.perf_counter() - t0
            hub.record("contrib_seconds", contrib_s, step=r)
            conn.send({
                "type": "contrib", "worker": worker_id, "round": r, "epoch": epoch,
                "state_rows": state_rows, "batch_rows": batch_rows, "seconds": contrib_s,
            })

            while True:  # await the gather (or a re-issue / resync / shutdown)
                m2 = conn.recv()
                if m2 is None:
                    return 1
                t2 = m2.get("type")
                if t2 == "gather" and int(m2["round"]) == r and int(m2["epoch"]) == epoch:
                    with tracer.span("gossip", trace=m2.get("trace", trace), step=r,
                                     epoch=epoch):
                        assembled = engine.set_stacked(post_local, m2["state"])
                        post_comm = engine.run_comm(assembled, m2["batch"], row)
                        synchronize(dev)
                    pending = (post_comm, k)
                    pending_round = r + 1
                    conn.send({
                        "type": "done", "worker": worker_id, "round": r, "epoch": epoch,
                        "leaves": wire_leaves(post_comm),
                        "key": np.array(k, np.int64),
                        "seconds": time.perf_counter() - t0,
                        "records": drained(r),
                    })
                    break
                if t2 in ("round", "resync", "shutdown"):
                    pushed = m2  # handle at the top of the outer loop
                    break
                # anything else (a stale gather from an older epoch): drop
    finally:
        stop.set()
        conn.close()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="elastic-runtime worker role (see repro_torch.runtime.launch)")
    parser.add_argument("--coordinator", required=True, metavar="HOST:PORT")
    parser.add_argument("--worker-id", type=int, required=True)
    parser.add_argument("--rejoin", action="store_true",
                        help="announce as a rejoining worker (state resync)")
    args = parser.parse_args(argv)
    sys.exit(run_worker(args.coordinator, args.worker_id, rejoin=args.rejoin))


if __name__ == "__main__":
    main()
