"""Scenario sweep: a grid runner over algorithm x scenario x tau x omega
x compressor x gossip channel.

Counterpart of ``repro.experiments.sweep``, with its flags, cell ids and
artifacts.  Each grid cell runs one decentralized training job through the
scenario engine -- on the Simulator (``--engines sim``), the sharded engine
(``--engines sharded``: ``--nodes`` nodes on one device), or both -- and
emits:

  * ``<out>/cells/<cell_id>.json``  -- full artifact: cell config, eval
    history, and the dense per-round streams (consensus distance, tracking
    error, effective spectral gap, active node count);
  * ``<out>/summary.jsonl``         -- one line per cell (final metrics);
  * optionally ``--bench-out``      -- a BENCH_*.json-style record of the run.

Cells run on the card unless ``--device cpu``.  The algorithms are built as
the reference builds them (no ``use_fused``): on the card the codecs'
kernels run in every cell with a compressor.  Minibatch indices, the tiny
LM's initial parameters and its tokens come from the port's own seeded
generators (the reference's come from threefry keys; parity tests inject
them: ``Simulator(index_fn=...)``, ``TrainJob.init_state(params=...)``,
:func:`sharded_tokens`).

Example (the paper's iid/non-iid table plus fault-robustness curves):

  PYTHONPATH=src python -m repro_torch.experiments.sweep \\
      --algorithms dse_mvr,dse_sgd,dlsgd --scenarios baseline,dropout_ring \\
      --taus 2,4 --omegas iid,0.5,10 --engines sim \\
      --nodes 8 --rounds 16 --out runs/sweep1 --device cpu
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import time
from typing import Any, Dict, List, Optional


def _parse_omega(s: str):
    return None if s in ("iid", "inf") else float(s)


def _jsonable(obj):
    """Strict-JSON-safe copy: non-finite floats become null (json.dump would
    happily emit bare ``NaN`` literals that jq / JSON.parse reject — and
    ``tracking_err`` is legitimately NaN for buffer-less methods)."""
    import math

    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    return obj


def _omega_tag(omega) -> str:
    return "iid" if omega is None else f"{omega:g}"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro_torch.experiments.sweep", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--algorithms", default="dse_mvr,dlsgd",
                   help="comma list of repro_torch.core.ALGORITHMS names")
    p.add_argument("--scenarios", default="baseline",
                   help="comma list of repro_torch.scenarios.SCENARIOS names")
    p.add_argument("--taus", default="4", help="comma list of ints")
    p.add_argument("--omegas", default="iid",
                   help="comma list of Dirichlet omegas ('iid' = uniform split)")
    p.add_argument("--compressors", default="identity",
                   help="comma list of repro_torch.compression specs "
                        "(identity, qsgd, top_k:0.1, rand_k:0.1, low_rank:2)")
    p.add_argument("--channels", default="sync",
                   help="comma list of gossip channel specs "
                        "(sync, choco, choco:0.8, async:2)")
    p.add_argument("--engines", default="sim",
                   help="comma list from {sim, sharded}")
    p.add_argument("--nodes", type=int, default=8)
    p.add_argument("--rounds", type=int, default=16,
                   help="communication rounds per cell (steps = rounds * round_len)")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=0.2,
                   help="sim-engine (classification) learning rate")
    p.add_argument("--sharded-lr", type=float, default=1e-2,
                   help="sharded-engine (tiny LM) learning rate")
    p.add_argument("--alpha", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--samples", type=int, default=800, help="sim dataset size")
    p.add_argument("--dim", type=int, default=16, help="sim feature dim")
    p.add_argument("--classes", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=16, help="sharded LM seq len")
    p.add_argument("--out", default="runs/sweep")
    p.add_argument("--bench-out", default=None,
                   help="also write a BENCH_*.json record here")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="bracket the whole sweep in torch.profiler, writing a "
                        "Chrome trace to DIR")
    p.add_argument("--device", default=None,
                   help="where the cells run: the card (the default) or 'cpu'")
    return p


# --------------------------------------------------------------------------
# engines
# --------------------------------------------------------------------------
_PROBLEM_CACHE: Dict[tuple, Any] = {}


def _sim_problem(args, omega):
    """Synthetic classification split across nodes (cached per omega, so a
    grid of cells over the same split re-partitions exactly once)."""
    import torch

    from ..data import (
        dirichlet_partition,
        iid_partition,
        make_classification,
        partition_to_node_data,
    )

    cache_key = (args.samples, args.dim, args.classes, args.nodes, args.seed,
                 omega)
    data = _PROBLEM_CACHE.get(cache_key)
    if data is None:
        x, y = make_classification(
            args.samples, args.dim, args.classes, seed=args.seed, class_sep=2.0
        )
        if omega is None:
            parts = iid_partition(len(x), args.nodes, seed=args.seed)
        else:
            parts = dirichlet_partition(
                y, args.nodes, omega=omega, seed=args.seed, min_per_node=2
            )
        data = partition_to_node_data(x, y, parts)
        _PROBLEM_CACHE[cache_key] = data

    def loss_fn(params, batch):
        """Each node's mean cross-entropy: x (N, b, dim), y (N, b) -> (N,)."""
        xb, yb = batch
        logits = torch.bmm(xb, params["w"]) + params["b"][:, None, :]
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(-1, yb[..., None]).squeeze(-1).mean(dim=-1)

    params = {
        "w": torch.zeros((args.dim, args.classes), dtype=torch.float32),
        "b": torch.zeros((args.classes,), dtype=torch.float32),
    }
    return data, loss_fn, params


def run_sim_cell(args, alg_name: str, scenario, tau: int, omega,
                 compressor: str = "identity",
                 channel: str = "sync", index_fn=None) -> Dict[str, Any]:
    """One cell on the Simulator; ``index_fn(step)`` gives the minibatch
    indices (default: the Simulator's generator seeded with ``--seed``)."""
    from ..core import Simulator, make_algorithm

    data, loss_fn, params = _sim_problem(args, omega)
    alg = make_algorithm(alg_name, lr=args.lr, alpha=args.alpha, tau=tau,
                         compression=compressor, channel=channel)
    sim = Simulator(
        alg, None, loss_fn, data, batch_size=args.batch_size, scenario=scenario,
        device=getattr(args, "device", None), seed=args.seed, index_fn=index_fn,
    )
    steps = args.rounds * sim.round_len
    t0 = time.perf_counter()
    out = sim.run(params, num_steps=steps, eval_every=steps)
    wall = time.perf_counter() - t0
    streams = {k: [float(v) for v in vals] for k, vals in out["streams"].items()}
    return {
        "history": out["history"],
        "streams": streams,
        "schedule_gaps": [float(g) for g in out["schedule"].spectral_gaps()],
        "final": out["history"][-1] if out["history"] else {},
        "wall_s": round(wall, 4),
    }


def sharded_tokens(args, round_len: int, vocab: int, r: int) -> Dict[str, Any]:
    """Round ``r``'s token and target batches of the sharded cell, ``(round_len,
    nodes, 2, seq_len)`` int64 each, from a numpy generator seeded with
    ``(--seed + 1, r)``."""
    import numpy as np

    rng = np.random.default_rng((args.seed + 1, r))
    shape = (round_len, args.nodes, 2, args.seq_len)
    return {"tokens": rng.integers(0, vocab, shape), "targets": rng.integers(0, vocab, shape)}


def run_sharded_cell(args, alg_name: str, scenario, tau: int, omega,
                     compressor: str = "identity",
                     channel: str = "sync") -> Dict[str, Any]:
    """One cell through the sharded engine (tiny LM, ``--nodes`` nodes on
    one device).

    omega has no LM analogue here -- per-node token streams are drawn by
    :func:`sharded_tokens` -- but the topology-schedule, fault and
    step-jitter axes exercise the exact same scheduled executor the
    Simulator uses.  Per-node batch-size jitter does NOT apply (batches are
    built by this driver; make_train_job warns when a scenario requests it).
    """
    import numpy as np

    from ..launch.distributed import make_train_job
    from ..launch.mesh import make_test_mesh
    from ..models import ModelConfig
    from ..scenarios.metrics import STREAM_FIELDS

    mesh = make_test_mesh(args.nodes, device=getattr(args, "device", None))
    cfg = ModelConfig(
        name="lm-tiny", arch_type="dense", n_layers=1, d_model=32,
        n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=256,
        block_unit=("attn",), tie_embeddings=True,
    )
    job = make_train_job(
        cfg, mesh, algorithm=alg_name, tau=tau, lr=args.sharded_lr,
        alpha=args.alpha, scenario=scenario, compression=compressor,
        channel=channel,
    )
    rl = job.round_len
    schedule = job.schedule_for(args.rounds)
    state = job.init_state(args.seed)

    history: List[Dict[str, float]] = []
    streams: Dict[str, List[float]] = {k: [] for k in STREAM_FIELDS}
    t0 = time.perf_counter()
    for r in range(args.rounds):
        batches = job.local_batch(sharded_tokens(args, rl, cfg.vocab_size, r))
        state, metrics = job.step_fn(state, batches, job.round_ctx(schedule, r))
        history.append({"round": r, "loss": float(metrics["loss"]),
                        "v_norm": float(metrics["v_norm"])})
        for k in STREAM_FIELDS:
            streams[k].append(float(metrics[k]))
    wall = time.perf_counter() - t0
    finite = all(np.isfinite(h["loss"]) for h in history)
    return {
        "history": history,
        "streams": streams,
        "schedule_gaps": [float(g) for g in schedule.spectral_gaps()],
        "final": {**history[-1], "finite": finite},
        "wall_s": round(wall, 4),
    }


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------
def run_sweep(args) -> List[Dict[str, Any]]:
    from ..scenarios import make_scenario
    from ..telemetry.spans import profile_trace

    with profile_trace(getattr(args, "profile", None)):
        return _run_sweep_grid(args, make_scenario)


def _run_sweep_grid(args, make_scenario) -> List[Dict[str, Any]]:
    algorithms = [a for a in args.algorithms.split(",") if a]
    scenario_names = [s for s in args.scenarios.split(",") if s]
    taus = [int(t) for t in args.taus.split(",") if t]
    omegas = [_parse_omega(o) for o in args.omegas.split(",") if o]
    compressors = [c for c in args.compressors.split(",") if c]
    channels = [c for c in getattr(args, "channels", "sync").split(",") if c]
    engines = [e for e in args.engines.split(",") if e]
    for e in engines:
        if e not in ("sim", "sharded"):
            raise ValueError(f"unknown engine {e!r}")

    os.makedirs(os.path.join(args.out, "cells"), exist_ok=True)
    summary_path = os.path.join(args.out, "summary.jsonl")
    rows: List[Dict[str, Any]] = []
    with open(summary_path, "w") as summary:
        for engine in engines:
            # the sharded cells train on node-seeded token streams — omega
            # has no effect there, so collapse the axis rather than emit
            # duplicate cells under different omega labels
            engine_omegas = omegas if engine == "sim" else omegas[:1]
            if engine == "sharded" and len(omegas) > 1:
                print(f"[sweep] sharded engine ignores omega; "
                      f"running omega={_omega_tag(omegas[0])} only")
            grid = itertools.product(
                algorithms, scenario_names, taus, compressors, channels,
                engine_omegas
            )
            for alg_name, scen_name, tau, compressor, chan, omega in grid:
                scenario = make_scenario(scen_name, seed=args.seed)
                comp_tag = compressor.replace(":", "")
                chan_tag = chan.replace(":", "")
                cell_id = (
                    f"{engine}-{alg_name}-{scen_name}"
                    f"-tau{tau}-omega{_omega_tag(omega)}"
                    + ("" if compressor == "identity" else f"-{comp_tag}")
                    + ("" if chan == "sync" else f"-{chan_tag}")
                )
                runner = run_sim_cell if engine == "sim" else run_sharded_cell
                result = runner(args, alg_name, scenario, tau, omega,
                                compressor, chan)
                cell = {
                    "cell_id": cell_id,
                    "engine": engine,
                    "algorithm": alg_name,
                    "scenario": scenario.to_config(),
                    "tau": tau,
                    "omega": _omega_tag(omega),
                    "compression": compressor,
                    "channel": chan,
                    "rounds": args.rounds,
                    "n_nodes": args.nodes,
                    "batch_size": args.batch_size,
                    "lr": args.lr if engine == "sim" else args.sharded_lr,
                    "seed": args.seed,
                }
                artifact = _jsonable({"cell": cell, **result})
                with open(
                    os.path.join(args.out, "cells", f"{cell_id}.json"), "w"
                ) as f:
                    json.dump(artifact, f, indent=1, allow_nan=False)
                row = {
                    **{k: v for k, v in cell.items() if k != "scenario"},
                    "scenario": scen_name,
                    "final": result["final"],
                    "mean_consensus": _mean(result["streams"].get("consensus")),
                    "mean_tracking_err": _mean(result["streams"].get("tracking_err")),
                    "mean_spectral_gap": _mean(result["streams"].get("spectral_gap")),
                    "mean_compression_err": _mean(result["streams"].get("compression_err")),
                    "mean_replica_drift": _mean(result["streams"].get("replica_drift")),
                    "mean_staleness": _mean(result["streams"].get("staleness")),
                    "mean_send_rate": _mean(result["streams"].get("send_rate")),
                    "wall_s": result["wall_s"],
                }
                row = _jsonable(row)
                summary.write(json.dumps(row, allow_nan=False) + "\n")
                summary.flush()
                rows.append(row)
                print(
                    f"[{len(rows):3d}] {cell_id:48s} "
                    f"wall={result['wall_s']:.2f}s "
                    f"final={result['final']}"
                )
    if args.bench_out:
        bench_rows = [
            {
                "bench": "scenarios_sweep",
                "name": f"sweep/{r['cell_id']}",
                "engine": r["engine"],
                "method": r["algorithm"],
                "scenario": r["scenario"],
                "tau": r["tau"],
                "omega": r["omega"],
                "compression": r.get("compression", "identity"),
                "channel": r.get("channel", "sync"),
                "rounds": r["rounds"],
                "final": r["final"],
                "mean_consensus": r["mean_consensus"],
                "mean_tracking_err": r["mean_tracking_err"],
                "mean_spectral_gap": r["mean_spectral_gap"],
                "mean_compression_err": r["mean_compression_err"],
                "mean_replica_drift": r.get("mean_replica_drift"),
                "mean_staleness": r.get("mean_staleness"),
                "mean_send_rate": r.get("mean_send_rate"),
                "wall_s": r["wall_s"],
            }
            for r in rows
        ]
        os.makedirs(os.path.dirname(args.bench_out) or ".", exist_ok=True)
        with open(args.bench_out, "w") as f:
            json.dump(_jsonable(bench_rows), f, indent=1, allow_nan=False)
    return rows


def _mean(xs: Optional[List[float]]):
    import numpy as np

    if not xs:
        return None
    arr = np.asarray(xs, dtype=np.float64)
    arr = arr[np.isfinite(arr)]
    return float(arr.mean()) if arr.size else None


def main(argv=None) -> List[Dict[str, Any]]:
    return run_sweep(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
