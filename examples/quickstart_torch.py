"""Quickstart on the PyTorch port: DSE-MVR vs the baselines on a non-iid
8-node ring.

The counterpart of ``examples/quickstart.py`` on ``repro_torch``: the
paper's core claim at toy scale -- under heterogeneous data with local
updates, dual-slow estimation + MVR reaches a better solution than plain
decentralized local SGD and drives the consensus distance to about 0.  The
update arithmetic runs through the fused-op kernels (Triton on CUDA; their
plain PyTorch versions on the CPU).

  PYTHONPATH=src python examples/quickstart_torch.py              # on CUDA
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu --smoke
"""
import argparse

import numpy as np
import torch

from repro_torch.core import Simulator, make_algorithm, ring
from repro_torch.data import dirichlet_partition, make_pseudo_mnist, partition_to_node_data
from repro_torch.device import resolve_device

N_NODES, TAU, BATCH, STEPS, SMOKE_STEPS = 8, 4, 32, 200, 40


def init(seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    return {
        "w1": torch.randn(196, 64, generator=gen) * 0.07,
        "b1": torch.zeros(64),
        "w2": torch.randn(64, 10, generator=gen) * 0.12,
        "b2": torch.zeros(10),
    }


def loss(params, batch):
    """Per-node cross-entropy: leaves (N, ...), x (N, b, 196), y (N, b) -> (N,)."""
    xb, yb = batch
    h = torch.tanh(torch.bmm(xb, params["w1"]) + params["b1"][:, None, :])
    logits = torch.bmm(h, params["w2"]) + params["b2"][:, None, :]
    return -torch.log_softmax(logits, -1).gather(-1, yb[..., None]).squeeze(-1).mean(-1)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--smoke", action="store_true", help=f"{SMOKE_STEPS} steps a method")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    steps = SMOKE_STEPS if args.smoke else STEPS

    # --- non-iid data: Dirichlet(0.5) label skew over an 8-node ring ------
    # (feature + label noise so the methods separate; the clean task
    # saturates every method at accuracy 1.0)
    x, y = make_pseudo_mnist(3000, side=14, seed=0)
    rng = np.random.default_rng(1)
    x = x + rng.normal(size=x.shape).astype(np.float32) * 2.5
    flip = rng.random(len(y)) < 0.05
    y = np.where(flip, rng.integers(0, 10, len(y)), y).astype(np.int32)
    xtr, ytr = x[:2000], y[:2000]
    xte = torch.as_tensor(x[2000:], device=dev)
    yte = torch.as_tensor(y[2000:], device=dev).long()
    parts = dirichlet_partition(ytr, N_NODES, omega=0.5, seed=0, min_per_node=20)
    data = partition_to_node_data(xtr, ytr, parts)
    top = ring(N_NODES)
    print(f"ring of {N_NODES} nodes, lambda = {top.lam:.3f}, tau = {TAU}, on {dev}")

    def acc(params):
        h = torch.tanh(xte @ params["w1"] + params["b1"])
        pred = (h @ params["w2"] + params["b2"]).argmax(-1)
        return {"test_acc": float((pred == yte).float().mean())}

    # one registry, one execution path: local-update methods and every-step
    # gossip baselines run through the same round executor
    hyper = dict(use_fused=True)
    algs = {
        "DSGD    ": make_algorithm("dsgd", lr=0.1, **hyper),
        "GT-DSGD ": make_algorithm("gt_dsgd", lr=0.1, **hyper),
        "DLSGD   ": make_algorithm("dlsgd", lr=0.3, tau=TAU, **hyper),
        "DSE-SGD ": make_algorithm("dse_sgd", lr=0.3, tau=TAU, **hyper),
        "DSE-MVR ": make_algorithm("dse_mvr", lr=0.3, alpha=0.05, tau=TAU, **hyper),
    }
    print(f"{'method':9s} {'train_loss':>10s} {'test_acc':>9s} {'consensus':>10s}")
    results = {}
    for name, alg in algs.items():
        sim = Simulator(alg, top, loss, data, batch_size=BATCH, eval_fn=acc, device=dev, seed=1)
        out = sim.run(init(0), steps, eval_every=steps)
        m = out["history"][-1]
        results[name.strip()] = m
        print(f"{name} {m['train_loss']:10.4f} {m['test_acc']:9.3f} {m['consensus']:10.2e}")
        assert np.isfinite([m["train_loss"], m["consensus"]]).all(), name
    return results


if __name__ == "__main__":
    main()
