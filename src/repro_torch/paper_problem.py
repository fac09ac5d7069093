"""The paper's experimental protocol at CPU scale, in PyTorch.

Counterpart of the problem in ``benchmarks/common.py``: pseudo-MNIST with
feature and label noise, Dirichlet(omega) partitioned over an 8-node ring,
a 196 -> 64 -> 10 tanh MLP, and the paper-tuned DSE-MVR / DSE-SGD and
baselines, optionally with compressed gossip (``compression="top_k:0.1"``,
``channel="choco"``, ...) and under a scenario of the scenario engine
(``scenario=make_scenario("dropout_ring")``, which replaces the static ring).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .core import ALGORITHMS, DLSGD, DSEMVR, DSESGD, PDSGDM, SlowMoD, Simulator, ring
from .core import make_algorithm as registry_make
from .data import dirichlet_partition, make_pseudo_mnist, partition_to_node_data
from .device import resolve_device
from .optim.schedules import decay_weight, paper_mnist_schedule

__all__ = [
    "N_NODES", "make_paper_problem", "mlp_init", "mlp_loss", "accuracy",
    "make_algorithm", "run_method",
]

N_NODES = 8
SIDE = 14
DIM = SIDE * SIDE
CLASSES = 10


def mlp_init(seed: int = 0, hidden: int = 64) -> Dict[str, torch.Tensor]:
    """Random MLP parameters on the CPU, from a seeded CPU generator (the
    same numbers whichever device the run then uses)."""
    gen = torch.Generator().manual_seed(seed)
    return {
        "w1": torch.randn(DIM, hidden, generator=gen) * (1.0 / np.sqrt(DIM)),
        "b1": torch.zeros(hidden),
        "w2": torch.randn(hidden, CLASSES, generator=gen) * (1.0 / np.sqrt(hidden)),
        "b2": torch.zeros(CLASSES),
    }


def mlp_loss(params, batch) -> torch.Tensor:
    """Per-node mean cross-entropy: params leaves (N, ...), x (N, b, DIM),
    y (N, b) -> (N,)."""
    x, y = batch
    h = torch.tanh(torch.bmm(x, params["w1"]) + params["b1"][:, None, :])
    logits = torch.bmm(h, params["w2"]) + params["b2"][:, None, :]
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, y[..., None]).squeeze(-1).mean(dim=-1)


def accuracy(params, x: torch.Tensor, y: torch.Tensor) -> float:
    """Test accuracy of one (unstacked) parameter set."""
    h = torch.tanh(x @ params["w1"] + params["b1"])
    pred = torch.argmax(h @ params["w2"] + params["b2"], dim=-1)
    return float((pred == y).float().mean())


def make_paper_problem(
    omega: float, seed: int = 0, n_train: int = 2000, n_test: int = 1000,
    noise: float = 2.5, label_noise: float = 0.05,
):
    """Pseudo-MNIST hardened with feature + label noise so the methods
    separate (the same arrays as the reference's, from the same seed)."""
    x, y = make_pseudo_mnist(n_train + n_test, side=SIDE, seed=seed)
    rng = np.random.default_rng(seed + 1)
    x = x + rng.normal(size=x.shape).astype(np.float32) * noise
    if label_noise:
        flip = rng.random(len(y)) < label_noise
        y = np.where(flip, rng.integers(0, CLASSES, len(y)), y).astype(np.int32)
    xtr, ytr = x[:n_train], y[:n_train]
    xte, yte = x[n_train:], y[n_train:]
    parts = dirichlet_partition(ytr, N_NODES, omega, seed=seed, min_per_node=20)
    data = partition_to_node_data(xtr, ytr, parts)
    return data, (xte, yte)


def make_algorithm(
    name: str, lr: float, tau: int, total_steps: int, alpha: float = 0.05,
    channel=None, compression=None,
    *, use_fused: bool = False, fuse_tracking_buffers: bool = False,
):
    """Paper-tuned hyperparameters per method, on top of the registry.

    ``channel`` / ``compression`` set the gossip protocol and wire codec."""
    comm = dict(channel=channel, compression=compression, use_fused=use_fused)
    sched = paper_mnist_schedule(lr, total_steps)
    if name == "dse_mvr":
        return DSEMVR(lr=sched, alpha=decay_weight(alpha, 0.99), tau=tau,
                      fuse_tracking_buffers=fuse_tracking_buffers, **comm)
    if name == "dse_sgd":
        return DSESGD(lr=sched, tau=tau, fuse_tracking_buffers=fuse_tracking_buffers, **comm)
    if name == "dlsgd":
        return DLSGD(lr=sched, tau=tau, **comm)
    if name == "pd_sgdm":
        return PDSGDM(lr=paper_mnist_schedule(lr * 0.3, total_steps), tau=tau, beta=0.9, **comm)
    if name == "slowmo_d":
        return SlowMoD(lr=sched, tau=tau, slow_lr=0.7, beta=0.6, **comm)
    if name in ALGORITHMS:  # every-step baselines: dsgd, gt_dsgd, gt_hsgd
        return registry_make(name, lr=paper_mnist_schedule(lr * 0.5, total_steps),
                             tau=tau, **comm)
    raise ValueError(f"unknown algorithm {name!r}; known: {sorted(ALGORITHMS)}")


def run_method(
    name: str, omega: float, tau: int, b: int, steps: int, seed: int = 0, lr: float = 0.3,
    channel=None, compression=None,
    *,
    use_fused: bool = False,
    fuse_tracking_buffers: bool = False,
    device=None,
    index_fn: Optional[Callable[[int], torch.Tensor]] = None,
    comm_seed_fn: Optional[Callable[[int, int, int], int]] = None,
    init_params: Optional[Dict[str, torch.Tensor]] = None,
    scenario=None,
    keep_state: bool = False,
    telemetry=None,
) -> Dict[str, Any]:
    """One paper run: final train loss, test accuracy, consensus and wall
    seconds.  ``init_params``, ``index_fn`` and ``comm_seed_fn`` default to
    the port's own seeded draws (parity tests pass the reference's).

    With a ``scenario`` the Simulator follows its schedule (no static
    topology) and the result adds ``"streams"``, the per-round metric
    streams (numpy); ``keep_state=True`` adds the final ``"state"``.  A
    ``telemetry`` hub (``repro_torch.telemetry.Telemetry``) is handed to the
    Simulator."""
    dev = resolve_device(device)
    data, (xte, yte) = make_paper_problem(omega, seed=seed)
    alg = make_algorithm(
        name, lr, tau, steps, channel=channel, compression=compression,
        use_fused=use_fused, fuse_tracking_buffers=fuse_tracking_buffers,
    )
    xte_t = torch.as_tensor(xte, device=dev)
    yte_t = torch.as_tensor(yte, device=dev).long()
    sim = Simulator(
        alg, None if scenario is not None else ring(N_NODES), mlp_loss, data, batch_size=b,
        eval_fn=lambda p: {"test_acc": accuracy(p, xte_t, yte_t)}, scenario=scenario,
        telemetry=telemetry, device=dev, seed=seed + 1, index_fn=index_fn,
        comm_seed_fn=comm_seed_fn,
    )
    params = init_params if init_params is not None else mlp_init(seed)
    t0 = time.perf_counter()
    out = sim.run(params, steps, eval_every=steps)   # ends in host floats
    wall = time.perf_counter() - t0
    final = out["history"][-1]
    result = {
        "train_loss": final["train_loss"],
        "test_acc": final["test_acc"],
        "consensus": final["consensus"],
        "wall_s": wall,
    }
    if scenario is not None:
        result["streams"] = out["streams"]
    if keep_state:
        result["state"] = out["state"]
    return result
