"""The port's scenario sweep (``repro_torch.experiments.sweep``) against
the reference's (``repro.experiments.sweep``) on the CPU.

The reference's ``main`` runs once for the module in a subprocess (its
sharded cells need the fake-device flag set before JAX starts): both
engines, DSE-MVR and DLSGD, an iid and a Dirichlet omega, 3 rounds on 4
nodes.  The port's ``main(["--device", "cpu", ...])`` runs the same grid
in this process with the reference's randomness injected: the Simulator
cells' minibatch indices (``run_sim_cell(index_fn=...)``, replayed from the
reference's key as ``test_torch_simulator.py`` does), the sharded cells'
tiny-LM initial parameters (``TrainJob.init_state``) and tokens
(``sharded_tokens``).

Held: the same cell ids, artifact, summary and ``--bench-out`` keys, strict
JSON; the Simulator cells' final metrics within the main path's band (rtol
5e-4 / atol 1e-5), the sharded cells' losses within the reference's band
between its sharded job and its one-device path (rtol 5e-3 / atol 1e-4).
"""
import functools
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models import Model as JModel
from repro.models import ModelConfig as JModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.experiments import sweep
from repro_torch.launch.distributed import TrainJob
from _reference_env import reference_env
from test_torch_simulator import _reference_indices

SIM_BAND = dict(rtol=5e-4, atol=1e-5)
SHARD_BAND = dict(rtol=5e-3, atol=1e-4)
DEADLINE = 600   # s, the reference's subprocess
ARGS = ["--engines", "sim,sharded", "--algorithms", "dse_mvr,dlsgd", "--omegas", "iid,0.5",
        "--rounds", "3", "--nodes", "4", "--taus", "2"]
TINY = dict(name="lm-tiny", arch_type="dense", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2,
            d_ff=64, vocab_size=256, block_unit=("attn",), tie_embeddings=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small ops: beside other test
    workers, a pool of one OpenMP thread per core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_tokens(args, round_len, vocab, r):
    """The reference's sharded-cell batches of round ``r``: its key chain
    from ``seed + 1``, split three ways a round."""
    key = jax.random.key(args.seed + 1)
    for _ in range(r + 1):
        key, k1, k2 = jax.random.split(key, 3)
    shape = (round_len, args.nodes, 2, args.seq_len)
    return {"tokens": np.asarray(jax.random.randint(k1, shape, 0, vocab)),
            "targets": np.asarray(jax.random.randint(k2, shape, 0, vocab))}


@pytest.fixture(scope="module")
def outs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sweep")
    env = reference_env(DEADLINE)   # the reference's sweep adds its fake devices
    ref = subprocess.run(
        [sys.executable, "-m", "repro.experiments.sweep", *ARGS, "--out", str(tmp / "ref"),
         "--bench-out", str(tmp / "ref" / "bench.json")],
        env=env, capture_output=True, text=True, timeout=DEADLINE)
    assert ref.returncode == 0, ref.stdout[-2000:] + ref.stderr[-4000:]

    args = sweep.build_parser().parse_args(ARGS)
    steps = args.rounds * max(int(t) for t in args.taus.split(","))

    def sim_cell(args, alg, scenario, tau, omega, compressor="identity", channel="sync"):
        n_i = sweep._sim_problem(args, omega)[0].samples_per_node
        idx = _reference_indices(jax.random.key(args.seed), steps, args.nodes,
                                 args.batch_size, n_i)
        return run_sim(args, alg, scenario, tau, omega, compressor, channel,
                       index_fn=lambda s: idx[s])

    init = params_from_numpy(jax.tree.map(np.asarray, JModel(JModelConfig(**TINY)).init(
        jax.random.key(args.seed))), "cpu")
    orig_init = TrainJob.init_state
    run_sim = sweep.run_sim_cell
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sweep, "run_sim_cell", sim_cell)
        mp.setattr(sweep, "sharded_tokens", _reference_tokens)
        mp.setattr(TrainJob, "init_state",
                   lambda self, seed=0, params=None: orig_init(self, seed, params=init))
        rows = sweep.main(ARGS + ["--out", str(tmp / "port"), "--bench-out",
                                  str(tmp / "port" / "bench.json"), "--device", "cpu"])
    return {"ref": tmp / "ref", "port": tmp / "port", "rows": rows}


def _cells(root: Path) -> dict:
    return {p.stem: json.loads(p.read_text()) for p in sorted((root / "cells").glob("*.json"))}


def _summary(root: Path) -> list:
    return [json.loads(line) for line in (root / "summary.jsonl").read_text().splitlines()]


def test_same_cells_artifacts_and_schema(outs):
    got, want = _cells(outs["port"]), _cells(outs["ref"])
    assert sorted(got) == sorted(want)
    assert len(got) == 2 * 2 + 2   # sim: 2 algorithms x 2 omegas; sharded: one omega
    for cid, art in got.items():
        assert set(art) == set(want[cid])
        assert art["cell"] == want[cid]["cell"]
        assert set(art["streams"]) == set(want[cid]["streams"])
        assert [sorted(h) for h in art["history"]] == [sorted(h) for h in want[cid]["history"]]
        assert art["schedule_gaps"] == pytest.approx(want[cid]["schedule_gaps"], rel=1e-6)
    gs, ws = _summary(outs["port"]), _summary(outs["ref"])
    assert [r["cell_id"] for r in gs] == [r["cell_id"] for r in ws]
    assert [sorted(r) for r in gs] == [sorted(r) for r in ws]
    assert [r["cell_id"] for r in outs["rows"]] == [r["cell_id"] for r in gs]
    gb = json.loads((outs["port"] / "bench.json").read_text())
    wb = json.loads((outs["ref"] / "bench.json").read_text())
    assert [sorted(r) for r in gb] == [sorted(r) for r in wb]
    assert [r["name"] for r in gb] == [r["name"] for r in wb]


@functools.lru_cache(maxsize=None)
def _pairs(root_port, root_ref):
    return _cells(Path(root_port)), _cells(Path(root_ref))


@pytest.mark.parametrize("cell", ["sim-dse_mvr-baseline-tau2-omegaiid",
                                  "sim-dse_mvr-baseline-tau2-omega0.5",
                                  "sim-dlsgd-baseline-tau2-omegaiid",
                                  "sim-dlsgd-baseline-tau2-omega0.5"])
def test_sim_cells_match_the_reference(outs, cell):
    got, want = (c[cell] for c in _pairs(str(outs["port"]), str(outs["ref"])))
    assert got["final"]["step"] == want["final"]["step"]
    for k in ("train_loss", "grad_norm_sq", "consensus"):
        np.testing.assert_allclose(got["final"][k], want["final"][k], **SIM_BAND)
    for k in ("consensus", "spectral_gap", "active_nodes"):
        np.testing.assert_allclose(got["streams"][k], want["streams"][k], **SIM_BAND)


@pytest.mark.parametrize("cell", ["sharded-dse_mvr-baseline-tau2-omegaiid",
                                  "sharded-dlsgd-baseline-tau2-omegaiid"])
def test_sharded_cells_match_the_reference(outs, cell):
    got, want = (c[cell] for c in _pairs(str(outs["port"]), str(outs["ref"])))
    assert got["final"]["finite"] and want["final"]["finite"]
    np.testing.assert_allclose([h["loss"] for h in got["history"]],
                               [h["loss"] for h in want["history"]], **SHARD_BAND)
    np.testing.assert_allclose(got["final"]["v_norm"], want["final"]["v_norm"], **SHARD_BAND)


def test_jsonable_is_strict_json():
    row = sweep._jsonable({"a": float("nan"), "b": [1.0, float("inf")], "c": (2, "x")})
    assert row == {"a": None, "b": [1.0, None], "c": [2, "x"]}
    json.dumps(row, allow_nan=False)
