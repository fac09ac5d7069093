"""Non-iid data partitioning across decentralized nodes.

A copy of ``repro.data.partition`` that builds the port's ``NodeData``.

The paper uses a Dirichlet process Dp(omega) to "strictly partition training
data" across nodes; omega -> 0 gives extreme label skew (non-iid), omega -> inf
approaches iid.  The paper's settings: omega = 0.5 (non-iid), omega = 10 (iid).
"""
from __future__ import annotations

import logging
from typing import List

import numpy as np

from ..core.simulate import NodeData

logger = logging.getLogger(__name__)

__all__ = ["dirichlet_partition", "iid_partition", "partition_to_node_data"]


def dirichlet_partition(
    labels: np.ndarray,
    n_nodes: int,
    omega: float,
    seed: int = 0,
    min_per_node: int = 1,
) -> List[np.ndarray]:
    """Index lists per node, class proportions ~ Dirichlet(omega) per class.

    Standard Dp(omega) label-skew protocol (Vogels et al.; Lin et al.): for each
    class, split its sample indices across nodes with proportions drawn from
    Dirichlet(omega * 1_N).  Retries until every node has >= min_per_node.
    """
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    classes = np.unique(labels)
    for _attempt in range(100):
        parts: List[list] = [[] for _ in range(n_nodes)]
        for c in classes:
            idx = np.flatnonzero(labels == c)
            rng.shuffle(idx)
            p = rng.dirichlet(np.full(n_nodes, omega))
            cuts = (np.cumsum(p) * len(idx)).astype(int)[:-1]
            for node, chunk in enumerate(np.split(idx, cuts)):
                parts[node].extend(chunk.tolist())
        if min(len(p) for p in parts) >= min_per_node:
            return [np.array(sorted(p), dtype=np.int64) for p in parts]
    raise RuntimeError("dirichlet_partition failed to give every node data")


def iid_partition(n_samples: int, n_nodes: int, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n_samples)
    return [np.sort(chunk) for chunk in np.array_split(idx, n_nodes)]


def partition_to_node_data(
    x: np.ndarray, y: np.ndarray, parts: List[np.ndarray], strict: bool = False
) -> NodeData:
    """Materialize per-node arrays, truncating to the smallest node (rectangular).

    Truncation discards data on skewed partitions (Dirichlet with small
    omega); the dropped count is logged and recorded on the returned
    ``NodeData.n_dropped``.  With ``strict=True`` any truncation raises
    instead of silently discarding samples.
    """
    n_i = min(len(p) for p in parts)
    n_dropped = int(sum(len(p) - n_i for p in parts))
    if n_dropped:
        total = sum(len(p) for p in parts)
        if strict:
            raise ValueError(
                f"rectangular partition would drop {n_dropped}/{total} samples "
                f"(smallest node has {n_i}); rebalance the partition or pass "
                "strict=False"
            )
        logger.warning(
            "partition_to_node_data: dropping %d/%d samples to the smallest "
            "node size %d", n_dropped, total, n_i,
        )
    xs = np.stack([x[p[:n_i]] for p in parts])
    ys = np.stack([y[p[:n_i]] for p in parts])
    return NodeData(x=xs, y=ys, n_dropped=n_dropped)
