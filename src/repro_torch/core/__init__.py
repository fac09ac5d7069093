"""Paper core of the port: DSE-MVR / DSE-SGD, baselines, topologies, gossip,
simulation.

The algorithm contract is the reference's (``repro.core``):

    init(params, full_grad_fn=None)                    -> state
    local_update(state, grad_fn)                       -> state   # no comm
    comm_update(state, mix_fn, grad_fn, reset_grad_fn) -> state   # gossip
    comm : CommSpec

``ALGORITHMS`` is the registry of all eight methods; :func:`make_algorithm`
builds any of them from one shared hyperparameter vocabulary.
"""
import dataclasses as _dataclasses

from .topology import (
    Topology, check_mixing_matrix, fully_connected, metropolis_hastings, ring,
    spectral_gap, star, torus,
)
from .algorithm import CommSpec, DecentralizedAlgorithm, RoundCtx, make_round_step
from .dse import DSEMVR, DSESGD, DSEState
from .baselines import DLSGD, DSGD, GTDSGD, GTHSGD, PDSGDM, SlowMoD
from .mixing import Rotation, dense_mix, scheduled_dense_mix
from .simulate import NodeData, Simulator, consensus_distance, node_mean

ALGORITHMS = {
    "dse_mvr": DSEMVR,
    "dse_sgd": DSESGD,
    "dsgd": DSGD,
    "dlsgd": DLSGD,
    "gt_dsgd": GTDSGD,
    "gt_hsgd": GTHSGD,
    "pd_sgdm": PDSGDM,
    "slowmo_d": SlowMoD,
}


def make_algorithm(name: str, **hyperparams) -> DecentralizedAlgorithm:
    """Instantiate a registered algorithm from a shared hyperparameter set.

    Keys that are not fields of the target class are dropped, so one call
    site can serve the whole registry (``alpha`` reaches only DSE-MVR,
    ``fuse_tracking_buffers`` only the DSE family).  ``tau`` is dropped for
    every-step methods, whose cadence fixes the round length to 1.
    """
    try:
        cls = ALGORITHMS[name]
    except KeyError:
        raise ValueError(f"unknown algorithm {name!r}; known: {sorted(ALGORITHMS)}") from None
    if cls.comm.cadence == "every_step":
        hyperparams.pop("tau", None)
    fields = {f.name for f in _dataclasses.fields(cls)}
    return cls(**{k: v for k, v in hyperparams.items() if k in fields})


__all__ = [
    "Topology", "ring", "torus", "fully_connected", "star",
    "metropolis_hastings", "spectral_gap", "check_mixing_matrix",
    "CommSpec", "DecentralizedAlgorithm", "RoundCtx", "make_round_step",
    "make_algorithm", "DSEMVR", "DSESGD", "DSEState",
    "DSGD", "DLSGD", "GTDSGD", "GTHSGD", "PDSGDM", "SlowMoD", "dense_mix",
    "scheduled_dense_mix", "Rotation",
    "Simulator", "NodeData", "node_mean", "consensus_distance", "ALGORITHMS",
]
