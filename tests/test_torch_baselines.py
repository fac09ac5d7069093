"""The port's six baselines (``repro_torch.core.baselines``) and the
registry against the reference (``repro.core`` + ``benchmarks/common.py``).

As in ``test_torch_simulator.py``, the reference's minibatch indices and
initial parameters are regenerated from its keys and injected.

Tolerances (the same as for DSE-MVR / DSE-SGD):
  * one round's state, rtol 1e-5 / atol 1e-6: fp32 reassociation between
    XLA and ATen (GEMMs, softmax, the dense mix) over one round;
  * ``run_method`` after 64 steps, rtol 5e-4 / atol 1e-5 on ``train_loss``
    and ``consensus``, and ``test_acc`` within 2/1000: the same per-step
    ulps compound over 64 steps.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from benchmarks import common as jcommon
from repro.core import ALGORITHMS as J_ALGORITHMS
from repro.core import DecentralizedAlgorithm as JDecentralizedAlgorithm
from repro.core import Simulator as JSimulator
from repro.core import make_algorithm as j_registry_make
from repro.core import ring as jring
from repro_torch import paper_problem as tproblem
from repro_torch.convert import tree_to_numpy
from repro_torch.core import ALGORITHMS as T_ALGORITHMS
from repro_torch.core import DecentralizedAlgorithm as TDecentralizedAlgorithm
from repro_torch.core import Simulator as TSimulator
from repro_torch.core import make_algorithm as t_registry_make
from repro_torch.core import ring as tring
from repro_torch.kernels import api as tapi
from test_torch_simulator import _reference_indices, _reference_init

STATE_TOL = dict(rtol=1e-5, atol=1e-6)
RUN_RTOL, RUN_ATOL, ACC_TOL = 5e-4, 1e-5, 2e-3
N, B, TAU, OMEGA, SEED = 8, 16, 4, 0.5, 0
BASELINES = ["dlsgd", "dsgd", "gt_dsgd", "gt_hsgd", "pd_sgdm", "slowmo_d"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's many small ops: beside other
    test workers, a pool of one OpenMP thread per core oversubscribes the
    CPU and spins, which slows these runs by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _reference_round(name):
    """Numpy state of the reference Simulator after one round of ``name``."""
    data, _ = jcommon.make_paper_problem(OMEGA, seed=SEED)
    alg = jcommon.make_algorithm(name, 0.3, TAU, 200)
    sim = JSimulator(alg, jring(N), jcommon.mlp_loss, data, batch_size=B)
    key = jax.random.key(SEED + 1)
    state = sim.init_state(jcommon.mlp_init(jax.random.key(SEED)), key)
    state, _ = sim.run_rounds(state, key, 1)
    return jax.tree.map(np.asarray, state), sim.round_len


def _port_sim(name, steps, use_fused, total_steps=200):
    data, _ = tproblem.make_paper_problem(OMEGA, seed=SEED)
    idx = _reference_indices(jax.random.key(SEED + 1), steps, N, B, data.samples_per_node)
    alg = tproblem.make_algorithm(name, 0.3, TAU, total_steps, use_fused=use_fused)
    return TSimulator(alg, tring(N), tproblem.mlp_loss, data, batch_size=B,
                      device="cpu", index_fn=lambda s: idx[s])


@pytest.mark.parametrize("use_fused", [False, True])
@pytest.mark.parametrize("name", BASELINES)
def test_one_round_state_matches_reference(name, use_fused):
    want, round_len = _reference_round(name)
    sim = _port_sim(name, round_len, use_fused)
    assert sim.round_len == round_len == (1 if name in ("dsgd", "gt_dsgd", "gt_hsgd") else TAU)
    state = sim.run_rounds(sim.init_state(_reference_init(SEED)), 1)
    assert state.step == int(want.step) == round_len
    assert type(state).__name__ == type(want).__name__
    assert state.comp is None and want.comp is None
    fields = [f.name for f in dataclasses.fields(state) if f.name not in ("step", "comp")]
    assert fields == [f.name for f in dataclasses.fields(want) if f.name not in ("step", "comp")]
    for field in fields:
        got = tree_to_numpy(getattr(state, field))
        for k, w in getattr(want, field).items():
            np.testing.assert_allclose(got[k], w, **STATE_TOL, err_msg=f"{field}.{k}")


@pytest.mark.parametrize("name", BASELINES)
def test_run_method_matches_reference(name):
    steps = 64
    want = jcommon.run_method(name, OMEGA, TAU, B, steps, seed=SEED)
    data, _ = tproblem.make_paper_problem(OMEGA, seed=SEED)
    idx = _reference_indices(jax.random.key(SEED + 1), steps, N, B, data.samples_per_node)
    got = tproblem.run_method(
        name, OMEGA, TAU, B, steps, seed=SEED, use_fused=True, device="cpu",
        index_fn=lambda s: idx[s], init_params=_reference_init(SEED),
    )
    for k in ("train_loss", "consensus"):
        np.testing.assert_allclose(got[k], want[k], rtol=RUN_RTOL, atol=RUN_ATOL, err_msg=k)
    assert abs(got["test_acc"] - want["test_acc"]) <= ACC_TOL


# every hyperparameter name any class takes, plus ones no class has
_VOCAB = dict(lr=0.1, tau=4, alpha=0.2, beta=0.3, slow_lr=0.5, nesterov=True,
              fuse_tracking_buffers=True, use_fused=True, state_dtype=None,
              no_such_field=1.0)


@pytest.mark.parametrize("name", sorted(J_ALGORITHMS))
def test_registry_filters_like_the_reference(name):
    assert sorted(T_ALGORITHMS) == sorted(J_ALGORITHMS)
    j, t = j_registry_make(name, **_VOCAB), t_registry_make(name, **_VOCAB)
    assert type(t).__name__ == type(j).__name__
    got = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
    want = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    assert got == want
    for attr in ("cadence", "buffers", "reset"):
        assert getattr(t.comm, attr) == getattr(j.comm, attr)
    assert t.comm.round_len(getattr(t, "tau", 1)) == j.comm.round_len(getattr(j, "tau", 1))
    assert t.comm.comm_events_per_round(4) == j.comm.comm_events_per_round(4)


@pytest.mark.parametrize("name", BASELINES)
def test_every_step_methods_have_no_local_update_like_the_reference(name):
    """GT-DSGD and GT-HSGD raise on ``local_update``; DSGD inherits DLSGD's."""
    j, t = j_registry_make(name, lr=0.1), t_registry_make(name, lr=0.1)
    for alg, base in ((j, JDecentralizedAlgorithm), (t, TDecentralizedAlgorithm)):
        has_local = type(alg).local_update is not base.local_update
        assert has_local == (name not in ("gt_dsgd", "gt_hsgd")), type(alg).__name__


def test_paper_tuned_hyperparameters_match_the_reference():
    for name in sorted(J_ALGORITHMS):
        j = jcommon.make_algorithm(name, 0.3, TAU, 200)
        t = tproblem.make_algorithm(name, 0.3, TAU, 200)
        assert type(t).__name__ == type(j).__name__
        for f in dataclasses.fields(t):
            want = getattr(j, f.name)
            if callable(want):   # schedules: the same fp32 values on the host
                assert [getattr(t, f.name)(s) for s in (0, 99, 100, 150, 199)] == \
                    [float(want(s)) for s in (0, 99, 100, 150, 199)], f.name
            else:
                assert getattr(t, f.name) == want, f.name


@pytest.mark.parametrize("name,ops", [
    ("gt_hsgd", {"axpby": 1, "mvr_update": 1, "add_sub": 1}),
    ("gt_dsgd", {"axpby": 1, "add_sub": 1}),
    ("dsgd", {"axpby": 1}),
    ("slowmo_d", {"axpby": 4 + 3}),     # 4 SGD steps + the slow update's 3
    ("pd_sgdm", {"axpby": 2 * 4}),
    ("dlsgd", {"axpby": 4}),
])
def test_fused_round_dispatches_one_call_per_op_and_bucket(name, ops):
    """On the fp32 MLP tree (one dtype bucket) a fused round makes one
    dispatch per op call: GT-HSGD's step is one axpby, one mvr_update and
    one add_sub.  On the CPU these are plain-version dispatches, no launch."""
    sim = _port_sim(name, TAU, use_fused=True)
    state = sim.init_state(_reference_init(SEED))
    tapi.reset_counters()
    sim.run_rounds(state, 1)
    assert tapi.call_counts() == ops
    assert tapi.launch_counts() == {}
