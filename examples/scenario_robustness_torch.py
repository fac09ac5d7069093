"""Fault robustness at toy scale on the PyTorch port: DSE-MVR vs DLSGD under
node dropout, plus async stale-mix gossip under lossy links.

The counterpart of ``examples/scenario_robustness.py`` on ``repro_torch``.
Part 1 runs the same non-iid 8-node problem through the scenario engine
twice per method -- the clean static ring and a ring with 15% per-round
node dropout -- and prints the final loss plus the per-round consensus and
active-node streams.  Part 2 adds the gossip channel axis: the
``async_lossy`` preset (20% link drops + a drift trigger that tightens over
the run) with an ``async:3`` stale-mix channel; the printed send rate is
the share of gossip traffic that actually moved.

  PYTHONPATH=src python examples/scenario_robustness_torch.py           # on CUDA
  PYTHONPATH=src python examples/scenario_robustness_torch.py --device cpu --smoke
"""
import argparse

import numpy as np
import torch

from repro_torch.core import Simulator, make_algorithm
from repro_torch.data import dirichlet_partition, make_classification, partition_to_node_data
from repro_torch.device import resolve_device
from repro_torch.scenarios import make_scenario

N_NODES, TAU, BATCH, STEPS, SMOKE_STEPS = 8, 4, 16, 160, 32
DIM, CLASSES = 16, 4


def loss_fn(params, batch):
    """Per-node cross-entropy: leaves (N, ...), x (N, b, DIM), y (N, b) -> (N,)."""
    xb, yb = batch
    logits = torch.bmm(xb, params["w"]) + params["b"][:, None, :]
    return -torch.log_softmax(logits, -1).gather(-1, yb[..., None]).squeeze(-1).mean(-1)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--smoke", action="store_true", help=f"{SMOKE_STEPS} steps a run")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    steps = SMOKE_STEPS if args.smoke else STEPS

    x, y = make_classification(1600, DIM, CLASSES, seed=0, class_sep=1.5)
    parts = dirichlet_partition(y, N_NODES, omega=0.5, seed=0, min_per_node=10)
    data = partition_to_node_data(x, y, parts)
    params = {"w": torch.zeros(DIM, CLASSES), "b": torch.zeros(CLASSES)}
    results = {}

    print(f"{'method':10s} {'scenario':14s} {'final loss':>10s} "
          f"{'consensus(end)':>14s} {'min active':>10s}")
    for name in ("dse_mvr", "dlsgd"):
        for scen in ("baseline", "dropout_ring"):
            alg = make_algorithm(name, lr=0.3, alpha=0.1, tau=TAU, use_fused=True)
            sim = Simulator(alg, None, loss_fn, data, BATCH, scenario=make_scenario(scen),
                            device=dev, seed=1)
            out = sim.run(params, num_steps=steps, eval_every=steps)
            s = out["streams"]
            loss = out["history"][-1]["train_loss"]
            results[name, scen] = loss
            assert np.isfinite(loss), (name, scen)
            print(f"{name:10s} {scen:14s} {loss:10.4f} "
                  f"{float(s['consensus'][-1]):14.6f} {int(np.min(s['active_nodes'])):10d}")

    # --- async stale-mix gossip under lossy links -------------------------
    print(f"\n{'channel':14s} {'scenario':12s} {'final loss':>10s} "
          f"{'send rate':>10s} {'staleness':>10s}")
    for channel in (None, "async:3"):
        alg = make_algorithm("dse_mvr", lr=0.3, alpha=0.1, tau=TAU, channel=channel,
                             use_fused=True)
        sim = Simulator(alg, None, loss_fn, data, BATCH, scenario=make_scenario("async_lossy"),
                        device=dev, seed=1)
        out = sim.run(params, num_steps=steps, eval_every=steps)
        s = out["streams"]
        rate = float(np.nanmean(s["send_rate"])) if channel else float("nan")
        stale = float(np.nanmean(s["staleness"])) if channel else float("nan")
        loss = out["history"][-1]["train_loss"]
        results[channel or "sync", "async_lossy"] = loss
        assert np.isfinite(loss), channel
        print(f"{channel or 'sync':14s} {'async_lossy':12s} {loss:10.4f} "
              f"{rate:10.3f} {stale:10.3f}")
    return results


if __name__ == "__main__":
    main()
