"""The port's Simulator on the paper problem (``repro_torch.paper_problem``)
against the reference (``repro.core.simulate`` + ``benchmarks/common.py``).

The reference draws minibatches with JAX threefry; the port does not
reimplement it.  These tests regenerate the reference's indices in
``Simulator._run_rounds``' split order (one ``split`` per iteration, the
subkey feeding ``randint``) and inject them, with the reference's initial
parameters, through ``index_fn`` and ``init_params``.

Tolerances:
  * one round's state, rtol 1e-5 / atol 1e-6: fp32 reassociation between
    XLA and ATen (GEMMs, softmax, the dense mix) over one round;
  * ``run_method`` after 64 / 200 steps, rtol 5e-4 / atol 1e-5 on
    ``train_loss`` and ``consensus`` (the repo's fused-vs-plain run
    tolerance): the same per-step ulps compound over 64 or 200 steps;
    ``test_acc`` within 2/1000 (at most two of the 1000 test points may
    flip class on that drift).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from benchmarks import common as jcommon
from repro.core import Simulator as JSimulator
from repro.core import ring as jring
from repro.data import dirichlet_partition as j_dirichlet
from repro.data import make_pseudo_mnist as j_pseudo_mnist
from repro.data import partition_to_node_data as j_to_node_data
from repro_torch import paper_problem as tproblem
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.core import Simulator as TSimulator
from repro_torch.core import ring as tring
from repro_torch.data import dirichlet_partition as t_dirichlet
from repro_torch.data import make_pseudo_mnist as t_pseudo_mnist
from repro_torch.data import partition_to_node_data as t_to_node_data

STATE_TOL = dict(rtol=1e-5, atol=1e-6)
RUN_RTOL, RUN_ATOL, ACC_TOL = 5e-4, 1e-5, 2e-3
N, B, TAU, OMEGA, SEED = 8, 16, 4, 0.5, 0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's many small ops: beside other
    test workers, a pool of one OpenMP thread per core oversubscribes the
    CPU and spins, which slows these runs by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_indices(key, steps, n_nodes, batch, n_i):
    """The reference's (steps, N, b) minibatch indices from ``key``."""
    out = []
    for _ in range(steps):
        key, sk = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(sk, (n_nodes, batch), 0, n_i)))
    return torch.from_numpy(np.stack(out))


def _reference_init(seed):
    return params_from_numpy(
        jax.tree.map(np.asarray, jcommon.mlp_init(jax.random.key(seed))), "cpu"
    )


@pytest.mark.parametrize("seed", [0, 3])
def test_numpy_modules_give_identical_arrays(seed):
    np.testing.assert_array_equal(tring(N).w, jring(N).w)
    xt, yt = t_pseudo_mnist(300, seed=seed)
    xj, yj = j_pseudo_mnist(300, seed=seed)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(yt, yj)
    pt = t_dirichlet(yt, N, OMEGA, seed=seed, min_per_node=5)
    pj = j_dirichlet(yj, N, OMEGA, seed=seed, min_per_node=5)
    assert len(pt) == len(pj) == N
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a, b)
    dt, dj = t_to_node_data(xt, yt, pt), j_to_node_data(xj, yj, pj)
    np.testing.assert_array_equal(dt.x, dj.x)
    np.testing.assert_array_equal(dt.y, dj.y)
    assert dt.n_dropped == dj.n_dropped


@functools.lru_cache(maxsize=None)
def _reference_round(name):
    """(numpy state after one round, data) of the reference Simulator."""
    data, _ = jcommon.make_paper_problem(OMEGA, seed=SEED)
    alg = jcommon.make_algorithm(name, 0.3, TAU, 200)
    sim = JSimulator(alg, jring(N), jcommon.mlp_loss, data, batch_size=B)
    key = jax.random.key(SEED + 1)
    state = sim.init_state(jcommon.mlp_init(jax.random.key(SEED)), key)
    state, _ = sim.run_rounds(state, key, 1)
    return jax.tree.map(np.asarray, state), data


@pytest.mark.parametrize("use_fused", [False, True])
@pytest.mark.parametrize("name", ["dse_mvr", "dse_sgd"])
def test_one_round_state_matches_reference(name, use_fused):
    want, jdata = _reference_round(name)
    data, _ = tproblem.make_paper_problem(OMEGA, seed=SEED)
    idx = _reference_indices(jax.random.key(SEED + 1), TAU, N, B, data.samples_per_node)
    alg = tproblem.make_algorithm(name, 0.3, TAU, 200, use_fused=use_fused)
    sim = TSimulator(alg, tring(N), tproblem.mlp_loss, data, batch_size=B,
                     device="cpu", index_fn=lambda s: idx[s])
    state = sim.run_rounds(sim.init_state(_reference_init(SEED)), 1)
    assert state.step == int(want.step) == TAU
    for field in ("params", "x_ref", "v", "y", "h_prev"):
        got = tree_to_numpy(getattr(state, field))
        for k, w in getattr(want, field).items():
            np.testing.assert_allclose(got[k], w, **STATE_TOL, err_msg=f"{field}.{k}")


@pytest.mark.parametrize("steps", [64, 200])
@pytest.mark.parametrize("name", ["dse_mvr", "dse_sgd"])
def test_run_method_matches_reference(name, steps):
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


def test_eval_snaps_to_round_boundaries_and_tail():
    """Eval points (multiples of eval_every) snap forward to the end of the
    round they fall in (10 -> 12, 20 -> 20; none falls in rounds 6-7); the
    trailing partial round runs local steps and is evaluated at num_steps."""
    data, _ = tproblem.make_paper_problem(OMEGA, seed=SEED)
    alg = tproblem.make_algorithm("dse_mvr", 0.3, TAU, 30)
    sim = TSimulator(alg, tring(N), tproblem.mlp_loss, data, batch_size=B, device="cpu")
    out = sim.run(tproblem.mlp_init(0), 30, eval_every=10)
    assert [h["step"] for h in out["history"]] == [12, 20, 30]
    assert out["state"].step == 30
    assert all(np.isfinite(h["train_loss"]) for h in out["history"])


def test_default_index_stream_is_seeded():
    data, _ = tproblem.make_paper_problem(OMEGA, seed=SEED)
    alg = tproblem.make_algorithm("dse_sgd", 0.3, TAU, 8)
    draws = []
    for _ in range(2):
        sim = TSimulator(alg, tring(N), tproblem.mlp_loss, data, batch_size=B,
                         device="cpu", seed=5)
        draws.append(torch.stack([sim.index_fn(t) for t in range(3)]))
    assert torch.equal(draws[0], draws[1])
    assert draws[0].shape == (3, N, B)
    assert int(draws[0].max()) < data.samples_per_node
