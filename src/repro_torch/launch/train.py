"""End-to-end decentralized LM training driver.

Counterpart of ``repro.launch.train``, with its flags and printed lines.
Runs real training with the sharded engine (``launch/distributed.py``) on
the card, or on the CPU with ``--device cpu``: one ``step_fn`` round per
iteration, checkpointing, metrics logging.

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --reduced \\
      --steps 100 --tau 4 --algorithm dse_mvr --out /tmp/run1 --device cpu

The node mesh is the reference's: W ranks are a ``data = max(1, W // 2)``
x ``model = W // data`` grid, and a world that leaves ranks outside it
raises.  Under the arch's sharding profile the data ranks are ``data``
nodes x a model axis (``NodeMesh(model=...)``, rank ``d M + m`` holding
model shard m of node d), or, under '2d' (Arctic 480B, Command R+ 104B),
where the reference's mesh has no 'pod' axis, one node of data x model
ranks (``NodeMesh(data=..., model=...)``: 8 ranks train one node over 4 x
2, printing ``mesh={'data': 4, 'model': 2}``), whose ``--compression`` and
``--channel`` bind each leaf's codec to its block over both groups.
A plain process is world 1: one node on its device, whose gossip is the
identity.  A process started as one rank of a group
(``torch.distributed.run`` sets ``RANK`` / ``WORLD_SIZE`` /
``MASTER_ADDR``) joins a gloo group; ranks may share one card.  Four
ranks are 2 nodes x 2 on ``ring(2)``, every codec and channel as at
model 1:

  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 -m repro_torch.launch.train --arch yi-9b --reduced

On a group, rank 0 alone prints, writes ``history.json`` and the
checkpoints (all N nodes' whole parameters, gathered over both axes of the
mesh, in the reference's format); each rank writes its own telemetry, rank
0 to ``--telemetry-out`` and rank r to ``<file>.rank<r>``, each counting
the link bytes its own shards of its nodes send and the kernel launches its
process made.

Elastic multi-process mode (``repro_torch.runtime``): ``--num-processes N``
runs the SAME decentralized rounds across N worker processes with
coordinator-driven membership:

  PYTHONPATH=src python -m repro_torch.launch.train --num-processes 4 \\
      --problem lm --steps 20 --tau 4 --algorithm dse_mvr

``--coordinator HOST:PORT --process-id I`` instead runs ONE worker role
joining an external coordinator.  ``--host-devices`` other than 1 and
``--jax-distributed`` (a worker's device mesh, which needs more than one
card and NCCL) are refused, ROADMAP queue 1 item 8 (b).  ``--profile DIR``
writes a ``torch.profiler`` Chrome trace of the training loop into DIR.
``--device`` is the port's one flag more: the card unless it says ``cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch.distributed as dist

from ..checkpoint import CheckpointManager
from ..configs import get_config, get_reduced
from ..core import ALGORITHMS
from ..data import TokenPipeline, make_lm_tokens
from .distributed import make_train_job
from .mesh import NodeMesh, make_group_mesh, make_test_mesh
from .sharding import PROFILES, ShardingProfile, profile_for_arch

__all__ = ["make_mesh_for_devices", "mesh_axes", "mesh_shape", "main"]


def _launched_as_rank() -> bool:
    """True in a process that ``torch.distributed.run`` (or any launcher
    setting its environment) started as one rank of a group of several."""
    return ("RANK" in os.environ and "MASTER_ADDR" in os.environ
            and int(os.environ.get("WORLD_SIZE", "1")) > 1)


def mesh_shape(world: int) -> tuple:
    """The reference's ``(data, model)`` grid for ``world`` devices:
    ``data = max(1, world // 2)``, ``model = world // data``.  The port has
    no idle ranks, so a world the grid does not cover raises."""
    data = max(1, world // 2)
    model = world // data
    if data * model != world:
        raise ValueError(
            f"a world of {world} ranks does not lay out as the reference's data x model "
            f"grid (data = max(1, W // 2) = {data}, model = W // data = {model}: "
            f"{data * model} ranks); launch an even number of ranks")
    return data, model


def make_mesh_for_devices(device=None, profile: Optional[ShardingProfile] = None) -> NodeMesh:
    """The reference's layout over the gloo group's ranks (joined from the
    launcher's environment when this process was started as one):
    :func:`mesh_shape`'s data x model grid, laid out as nodes by the arch's
    sharding ``profile`` (``ShardingProfile.node_grid``; 'tp' when None);
    else one node on ``device`` (CUDA unless ``"cpu"``)."""
    if _launched_as_rank() and not dist.is_initialized():
        dist.init_process_group("gloo")   # env://: MASTER_ADDR, RANK, WORLD_SIZE
    if dist.is_initialized():
        data, model = mesh_shape(dist.get_world_size())
        nodes, within = (profile or PROFILES["tp"]).node_grid(data)
        return make_group_mesh(nodes, device=device, model=model, data=within)
    return make_test_mesh(1, device=device)


def mesh_axes(mesh: NodeMesh) -> dict:
    """The mesh's axis sizes as the reference's CLI prints them: its
    ``(data, model)`` grid, a '2d' mesh's 'pod' axis of one left out."""
    axes = dict(zip(mesh.axis_names, mesh.devices.shape))
    if axes.get("pod") == 1:
        del axes["pod"]
    return axes


def _main_elastic(args):
    """--num-processes path: coordinator here, workers as real processes."""
    from ..runtime import RuntimeConfig, launch

    cfg = RuntimeConfig(
        problem=args.problem,
        algorithm=args.algorithm,
        hyper=(
            ("lr", args.lr), ("tau", args.tau), ("alpha", args.alpha),
            ("compression", args.compression), ("channel", args.channel),
        ),
        n_nodes=args.n_nodes,
        n_rounds=args.steps,
        batch_size=args.global_batch // max(args.n_nodes, 1) or 1,
        seed=args.seed,
        host_devices=args.host_devices,
        jax_distributed=args.jax_distributed,
        device=args.device or "cuda",
    )
    print(f"[train] elastic runtime: {args.num_processes} processes x "
          f"{cfg.host_devices} devices, {cfg.n_nodes} nodes, "
          f"{cfg.n_rounds} rounds ({cfg.problem}/{cfg.algorithm})")
    res = launch(cfg, args.num_processes, stream_path=args.telemetry_out,
                 trace_path=args.trace_out, http_port=args.http_port)
    print(f"[train] done: {res.rounds_per_sec:.2f} rounds/s, "
          f"final epoch {res.epochs[-1]}, wall {res.wall_s:.1f}s "
          f"(logs: {res.run_dir})")
    if res.trace_path:
        print(f"[train] trace: {res.trace_path} "
              f"(load in Perfetto / chrome://tracing)")
    if res.diagnostics:
        d = res.diagnostics
        anomalies = ", ".join(
            f"{a['kind']}@r{a['step']}" for a in d["anomalies"]
        ) or "none"
        print(f"[train] diagnostics: verdict={d['verdict']} "
              f"anomalies=[{anomalies}]")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        summary = {
            "config": cfg.to_config(),
            "n_processes": args.num_processes,
            "rounds_per_sec": res.rounds_per_sec,
            "epochs": res.epochs,
            "round_seconds": res.round_seconds,
            "resync_seconds": res.resync_seconds,
            "active_log": res.active_log.astype(int).tolist(),
            "wall_s": res.wall_s,
            "diagnostics": res.diagnostics,
        }
        with open(os.path.join(args.out, "elastic_summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
    return res


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="repro_torch.launch.train")
    p.add_argument("--arch", default="yi-9b")
    p.add_argument("--reduced", action="store_true", help="use the smoke-scale config")
    p.add_argument("--steps", type=int, default=50, help="communication rounds")
    p.add_argument("--tau", type=int, default=4)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--alpha", type=float, default=0.05)
    p.add_argument("--algorithm", default="dse_mvr", choices=sorted(ALGORITHMS))
    p.add_argument("--gossip", default="roll", choices=["roll", "dense"])
    p.add_argument("--use-fused", action="store_true",
                   help="route update arithmetic through the fused-op backend")
    p.add_argument("--compression", default=None,
                   help="gossip wire codec (repro_torch.compression spec, e.g. "
                        "qsgd, top_k:0.1, rand_k:0.1, low_rank:2)")
    p.add_argument("--channel", default=None,
                   help="gossip channel protocol (sync, choco, choco:0.8, "
                        "async:2); default is synchronous gossip")
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--ckpt-every", type=int, default=0)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="bracket the training loop in torch.profiler, writing a "
                        "Chrome trace to DIR")
    p.add_argument("--telemetry-out", default=None, metavar="FILE",
                   help="record fenced per-round spans, per-channel link-byte "
                        "counters and loss gauges to a run-stamped JSONL file")
    p.add_argument("--trace-out", default=None, metavar="FILE",
                   help="elastic mode: stitch every process's spans into one "
                        "Chrome trace-event / Perfetto JSON file (per-round "
                        "trace ids across coordinator + workers)")
    p.add_argument("--http-port", type=int, default=None, metavar="PORT",
                   help="elastic mode: serve the live fleet-health plane "
                        "(/metrics /healthz /trace /diagnostics) from the "
                        "coordinator on PORT (0 = ephemeral)")
    # elastic multi-process runtime (repro_torch.runtime)
    p.add_argument("--num-processes", type=int, default=0, metavar="N",
                   help="run the rounds across N real worker processes via "
                        "the elastic runtime (coordinator in this process)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="join an external elastic coordinator as one worker "
                        "role (requires --process-id)")
    p.add_argument("--process-id", type=int, default=0,
                   help="this worker's id under --coordinator")
    p.add_argument("--problem", default="lm",
                   help="elastic-mode problem registry name "
                        "(repro_torch.runtime.problems: mlp_blobs, pseudo_mnist, lm)")
    p.add_argument("--n-nodes", type=int, default=8,
                   help="elastic-mode logical node count (>= --num-processes)")
    p.add_argument("--host-devices", type=int, default=1,
                   help="devices a worker spans in elastic mode; only 1 "
                        "(ROADMAP queue 1 item 8 (b))")
    p.add_argument("--jax-distributed", action="store_true",
                   help="elastic mode: one device mesh across the group; refused "
                        "(ROADMAP queue 1 item 8 (b))")
    p.add_argument("--device", default=None,
                   help="where to train: the card (the default) or 'cpu'")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.host_devices != 1 or args.jax_distributed:
        from ..runtime import RuntimeConfig

        # refuses them, naming ROADMAP queue 1 item 8 (b)
        RuntimeConfig(host_devices=args.host_devices, jax_distributed=args.jax_distributed)

    if args.coordinator:
        from ..runtime.worker import run_worker

        return run_worker(args.coordinator, args.process_id)
    if args.num_processes:
        return _main_elastic(args)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    owns_group = _launched_as_rank() and not dist.is_initialized()
    mesh = make_mesh_for_devices(args.device, profile_for_arch(cfg.name))
    try:
        return _train(args, cfg, mesh)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, cfg, mesh: NodeMesh):
    m = 0 if mesh.model_group is None else mesh.model_group.index
    d = 0 if mesh.data_group is None else mesh.data_group.index
    rank = (mesh.rank * mesh.data + d) * mesh.model + m   # in the group: (p D + d) M + m
    lead = rank == 0

    def say(msg: str) -> None:
        if lead:
            print(msg, flush=True)

    say(f"[train] arch={cfg.name} mesh={mesh_axes(mesh)}")
    job = make_train_job(
        cfg, mesh, algorithm=args.algorithm, tau=args.tau,
        lr=args.lr, alpha=args.alpha, gossip=args.gossip,
        use_fused=args.use_fused, compression=args.compression,
        channel=args.channel,
    )
    n = job.n_nodes
    rl = job.round_len  # batches per round (1 for every-step methods)
    say(f"[train] {n} decentralized nodes ({job.profile.name} profile), "
        f"algorithm={args.algorithm}, round_len={rl}")
    if args.global_batch % max(n, 1):
        raise SystemExit(f"global batch {args.global_batch} not divisible by {n} nodes")

    # data: synthetic markov token stream, one shard per node; every rank
    # draws the same global batches and takes its own nodes' rows
    tokens = make_lm_tokens(2_000_000 if not args.reduced else 200_000,
                            cfg.vocab_size, seed=args.seed)
    pipe = TokenPipeline(tokens, args.seq_len, args.global_batch, seed=args.seed)

    state = job.init_state(args.seed)

    def round_batches():
        xs, ys = [], []
        for _ in range(rl):
            x, y = pipe.batch()
            xs.append(x.reshape(n, args.global_batch // n, args.seq_len))
            ys.append(y.reshape(n, args.global_batch // n, args.seq_len))
        return job.local_batch({"tokens": np.stack(xs), "targets": np.stack(ys)})

    ckpt = (CheckpointManager(os.path.join(args.out, "ckpt"))
            if args.out and args.ckpt_every and lead else None)

    tel = None
    link = None
    if args.telemetry_out:
        from ..compression.channels import link_bytes_per_round
        from ..telemetry import Telemetry

        tel = Telemetry(config=vars(args))
        # the link bytes this rank's nodes put on the wire a round
        link = link_bytes_per_round(job.algorithm.comm, state.params)
    from ..telemetry.spans import profile_trace, span

    history = []
    t0 = time.time()
    with profile_trace(args.profile):
        for r in range(args.steps):
            with span(tel, "round", step=r) as sp:
                state, metrics = job.step_fn(state, round_batches())
                sp.fence((state, metrics))
            loss = float(metrics["loss"])
            if tel is not None:
                tel.gauge("train_loss", loss, step=r + 1)
                tel.record_link_bytes(link, step=r)
            history.append({"round": r + 1, "loss": loss, "t": round(time.time() - t0, 2)})
            if (r + 1) % max(1, args.steps // 20) == 0 or r == 0:
                say(f"[train] round {r+1:4d}/{args.steps}  loss={loss:.4f}  "
                    f"({(time.time()-t0)/(r+1):.2f}s/round)")
            if args.out and args.ckpt_every and (r + 1) % args.ckpt_every == 0:
                params = job.full(state.params)   # every rank takes part
                if ckpt is not None:
                    ckpt.save(r + 1, params, {"loss": loss})
                del params
    if tel is not None:
        tel.record_kernel_launches()
        path = args.telemetry_out if lead else f"{args.telemetry_out}.rank{rank}"
        n_rec = tel.export_jsonl(path)
        print(f"[train] telemetry: {n_rec} records -> {path}", flush=True)
    if args.out and lead:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "history.json"), "w") as f:
            json.dump(history, f, indent=1)
    say(f"[train] done: loss {history[0]['loss']:.4f} -> {history[-1]['loss']:.4f}")
    return history


if __name__ == "__main__":
    main()
