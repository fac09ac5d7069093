"""Client heterogeneity profiles: per-node batch-size and local-step jitter.

A copy of ``repro.scenarios.heterogeneity`` (numpy only).

Layered on top of the Dirichlet label-skew partitioner (``repro_torch.data``):
Dp(omega) controls *statistical* heterogeneity of the shards, these profiles
control *system* heterogeneity of the clients — slow nodes take smaller
minibatches and/or miss local steps (Wu et al., arXiv:2403.15654 study
exactly this client/topology regime for local updates).

Batch-size jitter is shape-static: node i still draws ``batch_size`` sample
slots but only ``b_i`` *distinct* draws, tiled cyclically.  Because sampling
is with replacement, the mean gradient over the tiled slots has exactly the
distribution of a size-``b_i`` minibatch whenever ``b_i`` divides the batch
(and a close reweighting otherwise) — honest variance scaling without ragged
shapes.  ``b_i == batch_size`` reduces to the identity gather, so the
uniform profile stays bit-identical.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["ClientJitter", "uniform_profile"]


@dataclasses.dataclass(frozen=True)
class ClientJitter:
    """Per-node system heterogeneity.

    batch_frac_range: (lo, hi) — node i's batch fraction is drawn once (from
        the scenario seed) uniformly in [lo, hi]; b_i = max(1, round(frac*B)).
        (1.0, 1.0) means uniform batches.
    step_skip: extra per-(local step, node) skip probability applied on top
        of any straggler fault (a node-intrinsic slowness floor).
    """

    batch_frac_range: Tuple[float, float] = (1.0, 1.0)
    step_skip: float = 0.0
    name: str = "client_jitter"

    def __post_init__(self):
        lo, hi = self.batch_frac_range
        if not (0.0 < lo <= hi <= 1.0):
            raise ValueError(f"batch_frac_range {self.batch_frac_range} not in (0, 1]")
        if not (0.0 <= self.step_skip < 1.0):
            raise ValueError(f"step_skip {self.step_skip} not in [0, 1)")

    def node_batch_sizes(
        self, n_nodes: int, batch_size: int, rng: np.random.Generator
    ) -> Optional[np.ndarray]:
        lo, hi = self.batch_frac_range
        if lo == hi == 1.0:
            return None
        fracs = rng.uniform(lo, hi, size=n_nodes)
        return np.maximum(1, np.round(fracs * batch_size)).astype(np.int32)

    def apply_step_jitter(self, schedule, rng: np.random.Generator) -> None:
        if self.step_skip <= 0.0:
            return
        keep = rng.random(schedule.local_mask.shape) >= self.step_skip
        schedule.local_mask &= keep


def uniform_profile() -> ClientJitter:
    """The degenerate profile: identical, always-on clients."""
    return ClientJitter()
