"""Token/LM data pipeline with sharding-aware batching (a numpy copy of
``repro.data.pipeline``).

``TokenPipeline`` cuts a token stream into (batch, seq) examples; the
``ShardedBatcher`` hands each decentralized node (and each data shard within
serving) its slice, matching the global-batch layout the launcher expects.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = ["TokenPipeline", "ShardedBatcher"]


@dataclasses.dataclass
class TokenPipeline:
    tokens: np.ndarray
    seq_len: int
    batch_size: int
    seed: int = 0

    def __post_init__(self):
        n = (len(self.tokens) - 1) // self.seq_len
        if n < 1:
            raise ValueError("token stream shorter than one sequence")
        self._inputs = self.tokens[: n * self.seq_len].reshape(n, self.seq_len)
        self._targets = self.tokens[1 : n * self.seq_len + 1].reshape(n, self.seq_len)
        self._rng = np.random.default_rng(self.seed)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            idx = self._rng.integers(0, self._inputs.shape[0], size=self.batch_size)
            yield self._inputs[idx], self._targets[idx]

    def batch(self) -> Tuple[np.ndarray, np.ndarray]:
        idx = self._rng.integers(0, self._inputs.shape[0], size=self.batch_size)
        return self._inputs[idx], self._targets[idx]


@dataclasses.dataclass
class ShardedBatcher:
    """Splits a global batch into per-node slices: node i gets rows
    [i*B/N, (i+1)*B/N).  The distributed runtime shards the same layout over
    the node mesh axis, so simulation and production see identical data order.
    """

    pipeline: TokenPipeline
    n_nodes: int

    def global_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        x, y = self.pipeline.batch()
        if x.shape[0] % self.n_nodes:
            raise ValueError("global batch not divisible by node count")
        return x, y

    def node_batches(self) -> Tuple[np.ndarray, np.ndarray]:
        x, y = self.global_batch()
        b = x.shape[0] // self.n_nodes
        return (
            x.reshape(self.n_nodes, b, -1),
            y.reshape(self.n_nodes, b, -1),
        )
