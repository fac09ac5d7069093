"""Replay: the fault bridge from live membership back into the Simulator.

Counterpart of ``repro.runtime.replay``.  ``simulate_reference(config,
active_log)`` reruns an elastic run's exact fault schedule through the
single-process scheduled engine and returns the final state's wire leaves
-- the acceptance check is that they are BITWISE equal to the
multi-process run's canonical leaves.

Why this holds: the live coordinator derives each round's W_t / active /
local_mask by applying ``renormalize_dropout`` to the same fault-free base
schedule a :class:`~repro_torch.scenarios.RecordedFaults` replay rewrites
(same f64 renormalize, f32 store, same rng consumption since the recorded
model draws nothing), the workers run the same scheduled executor with the
same gates on the same index stream, codec seeds and initial parameters
(:class:`~repro_torch.runtime.engine.WorkerEngine`), and the gather
protocol reconstructs exactly the full-state inputs the Simulator sees.

The replay ALWAYS goes through RecordedFaults -- even for a fault-free run
(all-true log): the gated executor is compared with the gated one.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from ..scenarios import RecordedFaults, Scenario
from .config import RuntimeConfig

__all__ = ["replay_scenario", "simulate_reference", "leaves_equal"]


def replay_scenario(config: RuntimeConfig, active_log: np.ndarray) -> Scenario:
    """The scenario whose materialization reproduces the live schedules."""
    return Scenario(
        name="elastic_replay",
        topology=config.topology,
        faults=(RecordedFaults(active_log=tuple(map(tuple, np.asarray(active_log, dtype=bool)))),),
        seed=config.seed,
    )


def simulate_reference(
    config: RuntimeConfig,
    active_log: np.ndarray,
    *,
    device=None,
    index_fn: Optional[Callable] = None,
    comm_seed_fn: Optional[Callable] = None,
    init_params: Any = None,
) -> Dict[str, Any]:
    """Single-process run of the recorded fault schedule on ``device``
    (CUDA unless the CPU is asked for).

    By default it draws the engine's index stream
    (:func:`~repro_torch.runtime.engine.index_stream`), codec seeds
    (``default_comm_seed_fn(config.seed)``) and initial parameters
    (``problem.init_params(config.seed)``); ``index_fn``, ``comm_seed_fn``
    and ``init_params`` (an unstacked parameter tree) replace them.

    Returns the Simulator's result dict with ``"wire_leaves"`` (host numpy
    wire encoding of the final state, comparable leaf by leaf against
    :class:`~repro_torch.runtime.launch.ElasticResult.final_leaves`),
    ``"key"`` (the final step, an int64, as the runtime's key) and
    ``"metrics"`` (``Simulator.evaluate`` of the final state: full-data
    loss and gradient norm at the node mean, consensus) added."""
    from ..core import Simulator, make_algorithm
    from ..device import resolve_device
    from .engine import index_stream, wire_leaves
    from .problems import make_problem

    dev = resolve_device(device)
    problem = make_problem(config.problem, config.n_nodes, config.seed)
    alg = make_algorithm(config.algorithm, **config.hyperparams)
    if index_fn is None:
        index_fn = index_stream(config.seed, config.n_nodes, problem.data.samples_per_node,
                                config.batch_size, dev)
    sim = Simulator(
        alg, None, problem.loss_fn, problem.data, config.batch_size,
        scenario=replay_scenario(config, active_log),
        stream_metrics=False,
        device=dev, seed=config.seed, index_fn=index_fn, comm_seed_fn=comm_seed_fn,
    )
    params = problem.init_params(config.seed) if init_params is None else init_params
    out = sim.run(params, num_steps=config.n_rounds * sim.round_len, eval_every=0)
    out["wire_leaves"] = wire_leaves(out["state"])
    out["key"] = np.array(out["state"].step, np.int64)
    out["metrics"] = sim.evaluate(out["state"])
    return out


def leaves_equal(a, b, *, verbose: bool = False) -> Tuple[bool, int]:
    """Bitwise leaf-by-leaf comparison; returns (all_equal, first_bad_idx)."""
    a = [np.asarray(x) for x in a]
    b = [np.asarray(x) for x in b]
    if len(a) != len(b):
        return False, -1
    for i, (x, y) in enumerate(zip(a, b)):
        if x.shape != y.shape or x.dtype != y.dtype or not np.array_equal(x, y, equal_nan=True):
            if verbose:  # pragma: no cover - debug aid
                diff = (np.abs(x.astype(np.float64) - y.astype(np.float64)).max()
                        if x.shape == y.shape and x.dtype.kind in "biuf" else "n/a")
                print(f"leaf {i}: shape {x.shape}/{y.shape} dtype {x.dtype}/{y.dtype} "
                      f"maxdiff {diff}")
            return False, i
    return True, -1
