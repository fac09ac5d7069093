"""Deterministic synthetic datasets (the container has no dataset downloads).

``make_pseudo_mnist`` builds an MNIST-like 10-class image problem from fixed
class prototypes + structured noise: it preserves the properties the paper's
experiments rely on (multi-class, feature correlation within a class, label
skew possible via Dirichlet partition) while being fully offline and seeded.
"""
from __future__ import annotations

import numpy as np

__all__ = ["make_classification", "make_pseudo_mnist", "make_lm_tokens"]


def make_classification(
    n_samples: int,
    n_features: int,
    n_classes: int,
    seed: int = 0,
    noise: float = 1.0,
    class_sep: float = 2.0,
):
    """Gaussian blobs around random class prototypes."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(n_classes, n_features)) * class_sep
    y = rng.integers(0, n_classes, size=n_samples)
    x = protos[y] + rng.normal(size=(n_samples, n_features)) * noise
    return x.astype(np.float32), y.astype(np.int32)


def make_pseudo_mnist(
    n_samples: int = 4000,
    side: int = 14,
    n_classes: int = 10,
    seed: int = 0,
):
    """MNIST-like images: smooth class prototypes + per-sample deformation."""
    rng = np.random.default_rng(seed)
    d = side * side
    # smooth prototypes: low-frequency random fields per class
    freq = rng.normal(size=(n_classes, 4, 4))
    grid = np.linspace(0, 1, side)
    gx, gy = np.meshgrid(grid, grid, indexing="ij")
    basis = np.stack(
        [np.cos(np.pi * i * gx) * np.cos(np.pi * j * gy) for i in range(4) for j in range(4)],
        axis=0,
    )  # (16, side, side)
    protos = np.einsum("cf,fxy->cxy", freq.reshape(n_classes, 16), basis)
    y = rng.integers(0, n_classes, size=n_samples)
    x = protos[y] + 0.35 * rng.normal(size=(n_samples, side, side))
    x = np.tanh(x)
    return x.reshape(n_samples, d).astype(np.float32), y.astype(np.int32)


def make_lm_tokens(
    n_tokens: int,
    vocab_size: int,
    seed: int = 0,
    order: int = 2,
    zipf: float = 1.3,
):
    """Synthetic token stream: Zipf-distributed unigram marginal + a sparse
    Markov overlay.

    The Zipf marginal makes the task *quickly* learnable (the model first
    learns token frequencies, dropping loss well below ln(V) within a few
    steps) while the context->candidate structure rewards longer training.
    A uniform random-hash chain is a pure memorization task on which small
    models show no visible progress for hundreds of steps (measured)."""
    rng = np.random.default_rng(seed)
    branch = min(8, vocab_size)
    # zipf unigram weights over the vocab
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = ranks ** (-zipf)
    probs /= probs.sum()
    a, b = rng.integers(1, 2**31 - 1, size=2)
    toks = np.empty(n_tokens, dtype=np.int32)
    toks[:order] = rng.choice(vocab_size, size=order, p=probs)
    # candidate tables drawn from the zipf marginal (frequent tokens are
    # frequent continuations too)
    cand = rng.choice(vocab_size, size=(4096, branch), p=probs).astype(np.int32)
    choice = rng.integers(0, branch, size=n_tokens)
    for t in range(order, n_tokens):
        h = (a * int(toks[t - 1]) + b * int(toks[t - 2])) % 4096
        toks[t] = cand[h, choice[t]]
    return toks
