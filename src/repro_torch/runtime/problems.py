"""Problem registry for the elastic runtime: dataset + model + loss by name.

Counterpart of ``repro.runtime.problems``.  A problem is everything the run
computes ON -- fully derived from the config's seed so every worker (and
the single-process replay in ``repro_torch.runtime.replay``) rebuilds
byte-identical arrays independently:

    Problem(loss_fn, data: NodeData, init_params)

``data`` always carries ALL N nodes' shards, numpy arrays bit for bit the
reference's (``repro_torch.data`` is its numpy copy).  A worker then ZEROES
the rows it does not own (:func:`localize`): every driver keeps the full-N
program and the full (N, batch) index draw, while the worker genuinely
cannot produce another node's gradients -- its non-owned rows compute
finite garbage that the per-round gather overwrites with the owners' true
rows before any cross-node mixing reads them.

``loss_fn(params, batch)`` takes node-stacked parameters (leaves ``(N,
...)``) and batches and returns the ``(N,)`` per-node losses, the port's
Simulator convention.  ``init_params(seed)`` returns one unstacked
parameter tree of CPU tensors drawn from a CPU ``torch.Generator`` seeded
by ``seed``: every worker, on any device, derives the same numbers (not
the reference's ``jax.random`` ones; parity tests carry those across).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np
import torch

from ..core.simulate import NodeData
from ..data import iid_partition, make_classification, make_pseudo_mnist, partition_to_node_data
from ..paper_problem import mlp_loss

__all__ = ["Problem", "PROBLEMS", "register_problem", "make_problem", "localize"]


@dataclasses.dataclass
class Problem:
    loss_fn: Callable[[Any, Any], torch.Tensor]
    data: NodeData
    init_params: Callable[[int], Any]


def _mlp(d: int, hidden: int, classes: int):
    """(init, loss) of a 2-layer tanh MLP; the loss is the paper problem's."""
    def init(seed: int):
        gen = torch.Generator().manual_seed(int(seed))
        return {
            "w1": torch.randn(d, hidden, generator=gen) * (1.0 / np.sqrt(d)),
            "b1": torch.zeros(hidden),
            "w2": torch.randn(hidden, classes, generator=gen) * (1.0 / np.sqrt(hidden)),
            "b2": torch.zeros(classes),
        }

    return init, mlp_loss


def _partitioned(x: np.ndarray, y: np.ndarray, n_nodes: int, seed: int) -> NodeData:
    return partition_to_node_data(x, y, iid_partition(len(x), n_nodes, seed=seed))


PROBLEMS: Dict[str, Callable[..., Problem]] = {}


def register_problem(name: str):
    def deco(fn):
        PROBLEMS[name] = fn
        return fn

    return deco


@register_problem("mlp_blobs")
def _mlp_blobs(n_nodes: int, seed: int, n_features: int = 16, n_classes: int = 4,
               samples_per_node: int = 64, hidden: int = 32) -> Problem:
    """Gaussian-blob classification + 2-layer MLP: the fast CI problem."""
    x, y = make_classification(n_nodes * samples_per_node, n_features, n_classes, seed=seed)
    init, loss = _mlp(n_features, hidden, n_classes)
    return Problem(loss, _partitioned(x, y, n_nodes, seed), init)


@register_problem("pseudo_mnist")
def _pseudo_mnist(n_nodes: int, seed: int, samples_per_node: int = 128,
                  side: int = 14, hidden: int = 64) -> Problem:
    """The paper-protocol problem (the paper's 196 -> 64 -> 10 MLP) at
    runtime scale."""
    x, y = make_pseudo_mnist(n_nodes * samples_per_node, side=side, seed=seed)
    init, loss = _mlp(side * side, hidden, 10)
    return Problem(loss, _partitioned(x, y, n_nodes, seed), init)


@register_problem("lm")
def _lm(n_nodes: int, seed: int, arch: str = "dense_moe", seq_len: int = 32,
        samples_per_node: int = 16) -> Problem:
    """Reduced-architecture LM on synthetic tokens (generality check: the
    runtime drives whole transformer trees through the same row gather).

    The default ``arch`` is the reference's, which no registry knows: both
    packages refuse it, so pass a ported arch (``arch="gemma2_2b"``)."""
    from ..configs import get_reduced
    from ..data import make_lm_tokens
    from ..models.transformer import Model
    from ..tree import tree_map

    cfg = get_reduced(arch)
    model = Model(cfg)
    n_seq = n_nodes * samples_per_node
    toks = make_lm_tokens(n_seq * (seq_len + 1), cfg.vocab_size, seed=seed)
    toks = toks[: n_seq * (seq_len + 1)].reshape(n_seq, seq_len + 1)
    x, y = toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)

    def loss(params, batch):
        bx, by = batch
        return torch.stack([
            model.loss(tree_map(lambda p, i=i: p[i], params),
                       {"tokens": bx[i].long(), "targets": by[i].long()}, dtype=torch.float32)
            for i in range(bx.shape[0])
        ])

    def init(seed_: int):
        return model.init(seed_, dtype=torch.float32, device="cpu")

    return Problem(loss, _partitioned(x, y, n_nodes, seed), init)


def make_problem(name: str, n_nodes: int, seed: int, **kwargs) -> Problem:
    try:
        builder = PROBLEMS[name]
    except KeyError:
        raise ValueError(f"unknown problem {name!r}; known: {sorted(PROBLEMS)}") from None
    return builder(n_nodes, seed, **kwargs)


def localize(data: NodeData, owned: np.ndarray) -> NodeData:
    """Zero the data rows a worker does not own (same shapes, same sampling
    -- see module docstring).  Zero features/labels are valid model inputs,
    so non-owned gradient rows stay finite."""
    mask = np.zeros(data.n_nodes, dtype=bool)
    mask[np.asarray(owned)] = True

    def gate(a):
        out = np.zeros_like(a)
        out[mask] = a[mask]
        return out

    return NodeData(x=gate(data.x), y=gate(data.y), n_dropped=data.n_dropped)
