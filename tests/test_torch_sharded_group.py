"""The sharded engine (``repro_torch.launch.distributed.make_train_job``) on
spawned gloo groups, against itself across world sizes and against the
reference's ``make_train_job``.

  * Across world sizes: 8 nodes, lm-tiny, DSE-MVR tau=3, 3 rounds, on one
    rank in this process and on 2- and 4-rank gloo groups of spawned
    processes (this file is their script).  Roll gossip, sync QSGD (each
    rank numbers its codec rows from its first node) and CHOCO top-k 0.25
    with overlap, pre-rolled and with ``defer_roll``, are bit for bit;
    the dense contraction, whose GEMM shape changes with the rows a rank
    holds, within rtol 1e-6; the loss, ``v_norm`` and the scenario streams
    within rtol 1e-6 (they are sums over ranks).
  * The byte claims of the reference's ``tests/test_transport.py``, read
    from the mesh's counters (summed over ranks): CHOCO top-k 0.1 on
    ring(8) moves at least 4x fewer node-link bytes on the neighbour wire
    than with ``wire_mode="dense"``; under ``dropout_ring`` the compressed
    allgather gathers fewer bytes than the dense fallback, and its params
    stay within atol 1e-5 of it.
  * Against the reference: one subprocess runs the reference's
    ``make_train_job`` on 4 fake CPU devices (mesh (4, 1), roll gossip,
    DSE-MVR tau=3), one round uncompressed and one with CHOCO top-k 0.1 on
    the neighbour wire, from parameters drawn from a seed (the model's init
    plus 0.05 N(0, 1): its RMSNorm weights are all ones, an exact tie for
    top-k, whose winner would then turn on an ulp).  The port replays both
    on one rank and on a 2-rank group within the reference's own band
    between its sharded job and its single-device path, rtol 5e-3 / atol
    1e-4 (``tests/test_distributed.py``).
  * Every algorithm of ``ALGORITHMS`` builds and takes one finite step on a
    2-rank group with ``use_fused=True`` (CPU tensors take the plain
    versions).

Each group initializes from a ``FileStore`` under the test's temporary
directory; every process and the whole group have deadlines of their own,
so a hung gloo call fails its test.  Ranks run one torch thread each.
"""
import argparse
import datetime
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from _reference_env import reference_env

REPO = Path(__file__).resolve().parents[1]
N, TAU, ROUNDS, B, S, VOCAB = 8, 3, 3, 2, 16, 256
CFG = dict(name="lm-tiny", arch_type="dense", n_layers=1, d_model=32, n_heads=4,
           n_kv_heads=2, d_ff=64, vocab_size=VOCAB, block_unit=("attn",),
           tie_embeddings=True)
HYPER = dict(tau=TAU, lr=1e-2, alpha=0.1)
# case -> (make_train_job keywords, scenario preset or None, defer_roll)
CASES = {
    "roll": ({}, None, False),
    "qsgd": (dict(compression="qsgd"), None, False),
    "choco_overlap": (dict(channel="choco", compression="top_k:0.25", overlap=True), None, False),
    "choco_overlap_defer": (dict(channel="choco", compression="top_k:0.25", overlap=True),
                            None, True),
    "dense": (dict(gossip="dense"), None, False),
    "choco_auto": (dict(channel="choco", compression="top_k:0.1"), None, False),
    "choco_dense": (dict(channel="choco", compression="top_k:0.1", wire_mode="dense"),
                    None, False),
    "dropout_auto": (dict(channel="choco", compression="top_k:0.1"), "dropout_ring", False),
    "dropout_dense": (dict(channel="choco", compression="top_k:0.1", wire_mode="dense"),
                      "dropout_ring", False),
}
BITWISE = ("roll", "qsgd", "choco_overlap", "choco_overlap_defer")
WORLDS = (2, 4)
PROCESS_DEADLINE = 240     # s, one rank process
GROUP_DEADLINE = 300       # s, a whole group
REF_BAND = dict(rtol=5e-3, atol=1e-4)


# ------------------------------------------------------------ the rank side
def _batches(seed: int, n: int):
    rng = np.random.default_rng(seed)
    shape = (TAU, n, B, S)
    return {"tokens": rng.integers(0, VOCAB, shape), "targets": rng.integers(0, VOCAB, shape)}


def _rows(tree):
    from repro_torch.tree import tree_leaves

    return [t.detach().cpu().numpy() for t in tree_leaves(tree)]


def _job(mesh, kw, scenario, defer):
    import dataclasses

    from repro_torch.launch.distributed import make_train_job
    from repro_torch.models import ModelConfig
    from repro_torch.scenarios import make_scenario

    cfg = ModelConfig(**CFG)
    scen = make_scenario(scenario, seed=0) if scenario else None
    job = make_train_job(cfg, mesh, scenario=scen, **HYPER, **kw)
    if defer:
        alg = job.algorithm
        chan = alg.comm.resolved_channel()
        assert chan.overlap and not chan.defer_roll and chan.neighbor_shifts
        alg = dataclasses.replace(alg, channel=dataclasses.replace(chan, defer_roll=True))
        job = make_train_job(cfg, mesh, algorithm=alg, scenario=scen, **HYPER)
    return job


def run_cases(mesh, ref_npz=None, every_algorithm=False) -> dict:
    """The file's cases on ``mesh`` (8 nodes): this rank's final params, the
    per-round metrics and the mesh's byte counts; with ``ref_npz`` the
    reference replay on a 4-node mesh of the same group; with
    ``every_algorithm`` one fused step of every algorithm."""
    from repro_torch.launch.mesh import NodeMesh

    out = {}
    batches = _batches(1, N)
    for name, (kw, scenario, defer) in CASES.items():
        job = _job(mesh, kw, scenario, defer)
        state = job.init_state(0)
        local = job.local_batch(batches)
        sched = job.schedule_for(ROUNDS) if scenario else None
        mesh.reset_bytes()
        metrics = []
        for r in range(ROUNDS):
            if sched is None:
                state, m = job.step_fn(state, local)
            else:
                state, m = job.step_fn(state, local, job.round_ctx(sched, r))
            metrics.append({k: float(v) for k, v in m.items()})
        out[name] = {"params": _rows(state.params), "metrics": metrics,
                     "bytes": mesh.byte_counts(),
                     "wire": job.algorithm.comm.resolved_channel()}
    if ref_npz is not None:
        out["reference"] = replay_reference(NodeMesh(4, mesh.group, device="cpu"), ref_npz)
    if every_algorithm:
        out["algorithms"] = every_algorithm_step(mesh)
    return out


def _nest(npz, prefix):
    """``prefix/['a']['b']`` entries of the reference's npz as a nested dict."""
    out = {}
    for key in npz.files:
        if key.startswith(prefix + "/"):
            path = [p.strip("[]'") for p in key[len(prefix) + 1:].split("][")]
            d = out
            for p in path[:-1]:
                d = d.setdefault(p, {})
            d[path[-1]] = npz[key]
    return out


def replay_reference(mesh, ref_npz) -> dict:
    from repro_torch.convert import params_from_numpy

    npz = np.load(ref_npz)
    batches = {"tokens": npz["tokens"].astype(np.int64), "targets": npz["targets"].astype(np.int64)}
    out = {}
    for tag, kw in (("plain", {}), ("choco", dict(channel="choco", compression="top_k:0.1"))):
        job = _job(mesh, kw, None, False)
        state = job.init_state(params=params_from_numpy(_nest(npz, "init"), "cpu"))
        state, m = job.step_fn(state, job.local_batch(batches))
        out[tag] = {"params": _rows(state.params), "loss": float(m["loss"]),
                    "wire": job.algorithm.comm.resolved_channel()}
    return out


def every_algorithm_step(mesh) -> dict:
    from repro_torch.core import ALGORITHMS
    from repro_torch.launch.distributed import make_train_job
    from repro_torch.models import ModelConfig

    out = {}
    for name in sorted(ALGORITHMS):
        job = make_train_job(ModelConfig(**CFG), mesh, algorithm=name, use_fused=True, **HYPER)
        state = job.init_state(0)
        rng = np.random.default_rng(2)
        shape = (job.round_len, N, B, S)
        batches = {"tokens": rng.integers(0, VOCAB, shape),
                   "targets": rng.integers(0, VOCAB, shape)}
        state, m = job.step_fn(state, job.local_batch(batches))
        out[name] = {"round_len": job.round_len, "loss": float(m["loss"]),
                     "finite": all(bool(np.isfinite(p).all()) for p in _rows(state.params))}
    return out


def _rank_main(argv=None) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_group_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--ref", default=None)
    ap.add_argument("--every-algorithm", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(args.store, args.world),
                            rank=args.rank, world_size=args.world,
                            timeout=datetime.timedelta(seconds=PROCESS_DEADLINE))
    try:
        mesh = make_group_mesh(N, device="cpu")
        torch.save(run_cases(mesh, args.ref, args.every_algorithm), args.out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------- the parent side
def _spawn_group(world: int, tmp: Path, extra=()) -> list:
    """Run this file as ``world`` rank processes; their results by rank."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    store = tmp / f"store{world}"
    procs, outs = [], []
    for r in range(world):
        out = tmp / f"rank{world}_{r}.pt"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--rank", str(r), "--world", str(world),
             "--store", str(store), "--out", str(out), *extra],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + GROUP_DEADLINE
    logs = []
    try:
        for p in procs:
            left = max(1.0, min(PROCESS_DEADLINE, deadline - time.monotonic()))
            logs.append(p.communicate(timeout=left)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs))
           if p.returncode != 0]
    assert not bad, bad
    return [torch.load(o, weights_only=False) for o in outs]


REFERENCE = """
import os, sys
import jax, jax.numpy as jnp, numpy as np
from repro.compression.base import attach_channel_state
from repro.launch.distributed import make_train_job
from repro.launch.mesh import make_test_mesh
from repro.models import ModelConfig

cfg = ModelConfig(**{cfg})
mesh = make_test_mesh((4, 1), ("data", "model"))
rng = np.random.default_rng(0)
res = {{"tokens": rng.integers(0, {vocab}, ({tau}, 4, {b}, {s})).astype(np.int32),
       "targets": rng.integers(0, {vocab}, ({tau}, 4, {b}, {s})).astype(np.int32)}}
p0 = None
for tag, kw in (("plain", {{}}), ("choco", dict(channel="choco", compression="top_k:0.1"))):
    job = make_train_job(cfg, mesh, gossip="roll", **{hyper}, **kw)
    assert job.n_nodes == 4
    if p0 is None:
        p0 = jax.tree.map(lambda x: np.asarray(x) + np.float32(0.05) * rng.standard_normal(
            x.shape).astype(np.float32), job.model.init(jax.random.key(0)))
        for k, v in jax.tree_util.tree_flatten_with_path(p0)[0]:
            res["init/" + jax.tree_util.keystr(k)] = v
    stacked = jax.tree.map(lambda p: jnp.broadcast_to(jnp.asarray(p)[None], (4,) + p.shape), p0)
    state = attach_channel_state(job.algorithm, job.algorithm.init(stacked), jax.random.key(1))
    state, m = jax.jit(job.step_fn)(state, {{"tokens": jnp.asarray(res["tokens"]),
                                           "targets": jnp.asarray(res["targets"])}})
    for k, v in jax.tree_util.tree_flatten_with_path(state.params)[0]:
        res[tag + "/" + jax.tree_util.keystr(k)] = np.asarray(v)
    res[tag + "_loss"] = np.asarray(m["loss"])
    res[tag + "_shifts"] = np.asarray(getattr(job.algorithm.comm.resolved_channel(),
                                              "neighbor_shifts", ()), np.int64)
np.savez(sys.argv[1], **res)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every group's results: world 1 in this process, 2 and 4 spawned,
    and the reference's job, run once for the module."""
    from repro_torch.launch.mesh import make_test_mesh

    tmp = tmp_path_factory.mktemp("sharded")
    ref_npz = tmp / "reference.npz"
    env = reference_env(GROUP_DEADLINE, devices=4)
    code = textwrap.dedent(REFERENCE.format(cfg=CFG, vocab=VOCAB, tau=TAU, b=B, s=S,
                                            hyper=HYPER))
    ref = subprocess.Popen([sys.executable, "-c", code, str(ref_npz)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = run_cases(make_test_mesh(N, device="cpu"))
        try:
            log = ref.communicate(timeout=GROUP_DEADLINE)[0]
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
        assert ref.returncode == 0, log[-4000:]
        one["reference"] = replay_reference(make_test_mesh(4, device="cpu"), ref_npz)
    finally:
        torch.set_num_threads(n)
    groups = {2: _spawn_group(2, tmp, ("--ref", str(ref_npz), "--every-algorithm")),
              4: _spawn_group(4, tmp)}
    return {"one": one, "groups": groups, "ref": np.load(ref_npz)}


def _gathered(ranks, case):
    """A case's final params over all nodes, rank blocks concatenated."""
    return [np.concatenate(parts) for parts in zip(*(r[case]["params"] for r in ranks))]


def _global_bytes(results, case, op, kind="node_link"):
    ranks = results if isinstance(results, list) else [results]
    return sum(r[case]["bytes"][op][kind] for r in ranks)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", BITWISE)
def test_bit_for_bit_across_world_sizes(runs, case, world):
    """Roll gossip, sync QSGD and the overlapped CHOCO wire (pre-rolled and
    rolled at consume) give the one-rank run's bits on 2 and 4 ranks."""
    want = runs["one"][case]["params"]
    got = _gathered(runs["groups"][world], case)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert _global_bytes(runs["groups"][world], case, "roll", "process") > 0


@pytest.mark.parametrize("world", [1, *WORLDS])
def test_defer_roll_is_bit_for_bit_the_pre_rolled_wire(runs, world):
    ranks = [runs["one"]] if world == 1 else runs["groups"][world]
    a, b = _gathered(ranks, "choco_overlap"), _gathered(ranks, "choco_overlap_defer")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert ranks[0]["choco_overlap_defer"]["wire"].defer_roll


@pytest.mark.parametrize("world", WORLDS)
def test_dense_contraction_within_rtol_across_world_sizes(runs, world):
    want = runs["one"]["dense"]["params"]
    for g, w in zip(_gathered(runs["groups"][world], "dense"), want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    assert _global_bytes(runs["groups"][world], "dense", "all_gather", "process") > 0


@pytest.mark.parametrize("world", WORLDS)
def test_metrics_and_streams_agree_across_world_sizes(runs, world):
    for case in CASES:
        want = runs["one"][case]["metrics"]
        for rank in runs["groups"][world]:
            got = rank[case]["metrics"]
            assert [sorted(m) for m in got] == [sorted(m) for m in want], case
            for g, w in zip(got, want):
                for k in w:
                    np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=1e-7,
                                               err_msg=f"{case} {k}")
    streams = runs["one"]["dropout_auto"]["metrics"][-1]
    assert {"consensus", "spectral_gap", "active_nodes", "replica_drift"} <= set(streams)


@pytest.mark.parametrize("world", [1, *WORLDS])
def test_neighbor_wire_moves_4x_fewer_node_link_bytes(runs, world):
    results = runs["one"] if world == 1 else runs["groups"][world]
    auto = _global_bytes(results, "choco_auto", "roll")
    dense = _global_bytes(results, "choco_dense", "roll")
    assert dense >= 4 * auto > 0, (dense, auto)
    one = results if world == 1 else results[0]
    assert one["choco_auto"]["wire"].neighbor_shifts
    assert not one["choco_dense"]["wire"].neighbor_shifts


@pytest.mark.parametrize("world", [1, *WORLDS])
def test_compressed_allgather_beats_the_dense_fallback_under_dropout(runs, world):
    results = runs["one"] if world == 1 else runs["groups"][world]
    ranks = [results] if world == 1 else results
    packed = _global_bytes(results, "dropout_auto", "all_gather")
    dense = _global_bytes(results, "dropout_dense", "all_gather")
    assert 0 < packed < dense, (packed, dense)
    assert ranks[0]["dropout_auto"]["wire"].replicated_wire
    for a, b in zip(_gathered(ranks, "dropout_auto"), _gathered(ranks, "dropout_dense")):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("tag", ["plain", "choco"])
def test_train_job_matches_the_reference(runs, tag, world):
    """The reference's band between its sharded job and its single-device
    path (``tests/test_distributed.py``): rtol 5e-3 / atol 1e-4."""
    from repro_torch.tree import tree_leaves

    ref = runs["ref"]
    ranks = [runs["one"]] if world == 1 else runs["groups"][world]
    got = [np.concatenate(parts) for parts in zip(*(r["reference"][tag]["params"]
                                                   for r in ranks))]
    want = [np.asarray(x) for x in tree_leaves(_nest(ref, tag))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **REF_BAND)
    np.testing.assert_allclose(ranks[0]["reference"][tag]["loss"], float(ref[tag + "_loss"]),
                               rtol=1e-4)
    wire = ranks[0]["reference"][tag]["wire"]
    assert tuple(ref[tag + "_shifts"]) == (() if wire is None else wire.neighbor_shifts)


@pytest.mark.parametrize("name", ["dlsgd", "dse_mvr", "dse_sgd", "dsgd", "gt_dsgd", "gt_hsgd",
                                  "pd_sgdm", "slowmo_d"])
def test_every_algorithm_steps_on_two_ranks(runs, name):
    from repro_torch.core import ALGORITHMS

    got = {r_i: r["algorithms"][name] for r_i, r in enumerate(runs["groups"][2])}
    assert set(ALGORITHMS) == set(runs["groups"][2][0]["algorithms"])
    want_len = 1 if ALGORITHMS[name].comm.cadence == "every_step" else TAU
    for res in got.values():
        assert res["round_len"] == want_len and res["finite"] and np.isfinite(res["loss"])
    assert got[0]["loss"] == got[1]["loss"]


if __name__ == "__main__":
    _rank_main()
