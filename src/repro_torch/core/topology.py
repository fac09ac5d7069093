"""Decentralized communication topologies and mixing matrices.

The paper (Assumption 5) requires a symmetric doubly-stochastic mixing matrix
``W`` with spectral gap ``lambda = ||W - Q|| < 1`` where ``Q = (1/N) 11^T``.
Experiments use a ring graph with Metropolis-Hastings weights
``w_ij = 1 / (max(deg(i), deg(j)) + 1)``.

This module builds ``W`` for the standard graph families, checks Assumption 5,
and exposes the neighbor structure needed by the sparse (collective-permute)
gossip backend.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "Topology",
    "ring",
    "torus",
    "fully_connected",
    "star",
    "metropolis_hastings",
    "spectral_gap",
    "check_mixing_matrix",
]


@dataclasses.dataclass(frozen=True)
class Topology:
    """A communication graph plus its mixing matrix.

    Attributes:
      name: human-readable family name.
      n: number of nodes.
      w: (n, n) symmetric doubly-stochastic mixing matrix (numpy, float64).
      neighbors: per-node list of neighbor ids (excluding self).
      shifts: for shift-structured graphs (ring/torus) the list of cyclic
        shifts s such that node i's neighbor set is {i + s mod n}; used by the
        collective-permute gossip backend. Empty for unstructured graphs.
    """

    name: str
    n: int
    w: np.ndarray
    neighbors: tuple[tuple[int, ...], ...]
    shifts: tuple[int, ...] = ()

    @property
    def lam(self) -> float:
        return spectral_gap(self.w)

    def self_weight(self, i: int = 0) -> float:
        return float(self.w[i, i])

    def shift_weights(self) -> tuple[float, ...]:
        """Weights aligned with ``shifts`` (valid for shift-structured graphs)."""
        if not self.shifts:
            raise ValueError(f"{self.name} topology is not shift-structured")
        return tuple(float(self.w[0, s % self.n]) for s in self.shifts)


def metropolis_hastings(adj: np.ndarray) -> np.ndarray:
    """Metropolis-Hastings weights for an undirected graph adjacency matrix.

    ``w_ij = 1 / (max(deg_i, deg_j) + 1)`` for edges, ``w_ii = 1 - sum_j w_ij``.
    For a regular graph this reduces to the paper's
    ``w_ij = 1/(deg+1)`` (ring: 1/3 self, 1/3 each neighbor).
    """
    adj = np.asarray(adj, dtype=bool)
    n = adj.shape[0]
    if adj.shape != (n, n):
        raise ValueError("adjacency must be square")
    if adj.diagonal().any():
        raise ValueError("adjacency must have empty diagonal")
    if not (adj == adj.T).all():
        raise ValueError("adjacency must be symmetric")
    deg = adj.sum(axis=1)
    w = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        for j in range(n):
            if adj[i, j]:
                w[i, j] = 1.0 / (max(deg[i], deg[j]) + 1.0)
    w[np.diag_indices(n)] = 1.0 - w.sum(axis=1)
    return w


def spectral_gap(w: np.ndarray) -> float:
    """``lambda = ||W - Q||_2`` (second-largest singular value of W)."""
    n = w.shape[0]
    q = np.full((n, n), 1.0 / n)
    return float(np.linalg.norm(w - q, ord=2))


def check_mixing_matrix(w: np.ndarray, atol: float = 1e-9) -> None:
    """Validate Assumption 5: symmetric, doubly stochastic, lambda in [0, 1)."""
    n = w.shape[0]
    if not np.allclose(w, w.T, atol=atol):
        raise ValueError("W must be symmetric")
    if not np.allclose(w.sum(axis=1), 1.0, atol=atol):
        raise ValueError("W rows must sum to 1")
    if not np.allclose(w.sum(axis=0), 1.0, atol=atol):
        raise ValueError("W cols must sum to 1")
    lam = spectral_gap(w)
    if n > 1 and not (0.0 <= lam < 1.0):
        raise ValueError(f"spectral gap lambda={lam} not in [0, 1)")


def _topology_from_adj(name: str, adj: np.ndarray, shifts: Sequence[int]) -> Topology:
    w = metropolis_hastings(adj)
    check_mixing_matrix(w)
    n = adj.shape[0]
    neighbors = tuple(tuple(int(j) for j in np.flatnonzero(adj[i])) for i in range(n))
    # a shift s is only usable by the collective-permute backend if it is a
    # graph automorphism edge for EVERY node, and together the shifts must
    # cover every edge; otherwise the topology is not shift-structured.
    valid = tuple(
        s for s in shifts if all(adj[j, (j + s) % n] for j in range(n))
    )
    covered = len(valid) == adj[0].sum() and all(
        sum(1 for s in valid if (j + s) % n == k) == 1
        for j in range(min(n, 4))
        for k in np.flatnonzero(adj[j])
    )
    return Topology(
        name=name, n=n, w=w, neighbors=neighbors,
        shifts=valid if covered else (),
    )


def ring(n: int) -> Topology:
    """Ring graph (the paper's experimental topology)."""
    if n < 1:
        raise ValueError("n >= 1")
    adj = np.zeros((n, n), dtype=bool)
    for i in range(n):
        adj[i, (i + 1) % n] = True
        adj[i, (i - 1) % n] = True
    adj[np.diag_indices(n)] = False
    if n == 1:
        return Topology("ring", 1, np.ones((1, 1)), ((),), ())
    if n == 2:
        return _topology_from_adj("ring", adj, shifts=(1,))
    return _topology_from_adj("ring", adj, shifts=(1, n - 1))


def torus(rows: int, cols: int) -> Topology:
    """2-D torus over ``rows*cols`` nodes (node id = r*cols + c)."""
    n = rows * cols
    adj = np.zeros((n, n), dtype=bool)
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                j = ((r + dr) % rows) * cols + (c + dc) % cols
                if j != i:
                    adj[i, j] = True
    shifts: list[int] = []
    for s in (cols, n - cols, 1, n - 1):
        if 0 < s < n and s not in shifts and adj[0, s]:
            shifts.append(s)
    return _topology_from_adj("torus", adj, shifts=shifts)


def fully_connected(n: int) -> Topology:
    """Complete graph; MH weights give W = Q exactly (lambda = 0)."""
    adj = ~np.eye(n, dtype=bool)
    if n == 1:
        return Topology("full", 1, np.ones((1, 1)), ((),), ())
    return _topology_from_adj("full", adj, shifts=tuple(range(1, n)))


def star(n: int) -> Topology:
    """Star graph (hub node 0) — a high-lambda stress topology."""
    adj = np.zeros((n, n), dtype=bool)
    adj[0, 1:] = True
    adj[1:, 0] = True
    return _topology_from_adj("star", adj, shifts=())
