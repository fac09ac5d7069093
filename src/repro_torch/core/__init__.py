"""Paper core of the port: DSE-MVR / DSE-SGD, topologies, gossip, simulation.

The algorithm contract is the reference's (``repro.core``):

    init(params, full_grad_fn=None)                    -> state
    local_update(state, grad_fn)                       -> state   # no comm
    comm_update(state, mix_fn, grad_fn, reset_grad_fn) -> state   # gossip
    comm : CommSpec

``ALGORITHMS`` holds the methods ported so far; the baselines are ROADMAP
queue 1 item 3.
"""
import dataclasses as _dataclasses

from .topology import (
    Topology, check_mixing_matrix, fully_connected, metropolis_hastings, ring,
    spectral_gap, star, torus,
)
from .algorithm import CommSpec, DecentralizedAlgorithm, make_round_step
from .dse import DSEMVR, DSESGD, DSEState
from .mixing import dense_mix
from .simulate import NodeData, Simulator, consensus_distance, node_mean

ALGORITHMS = {
    "dse_mvr": DSEMVR,
    "dse_sgd": DSESGD,
}


def make_algorithm(name: str, **hyperparams) -> DecentralizedAlgorithm:
    """Instantiate a registered algorithm from a shared hyperparameter set.

    Keys that are not fields of the target class are dropped, so one call
    site can serve the whole registry.
    """
    try:
        cls = ALGORITHMS[name]
    except KeyError:
        raise ValueError(
            f"unknown algorithm {name!r}; repro_torch has {sorted(ALGORITHMS)} "
            "(the baselines are ROADMAP queue 1 item 3)"
        ) from None
    if cls.comm.cadence == "every_step":
        hyperparams.pop("tau", None)
    fields = {f.name for f in _dataclasses.fields(cls)}
    return cls(**{k: v for k, v in hyperparams.items() if k in fields})


__all__ = [
    "Topology", "ring", "torus", "fully_connected", "star",
    "metropolis_hastings", "spectral_gap", "check_mixing_matrix",
    "CommSpec", "DecentralizedAlgorithm", "make_round_step",
    "make_algorithm", "DSEMVR", "DSESGD", "DSEState", "dense_mix",
    "Simulator", "NodeData", "node_mean", "consensus_distance", "ALGORITHMS",
]
