"""The within-node layouts of the sharded engine (``make_train_job`` with a
sharding profile on a ``NodeMesh`` with a model axis) on spawned gloo
groups, against the reference's ``make_train_job`` and against the model-1
job.

  * Against the reference: one subprocess runs the reference's
    ``make_train_job(..., profile=PROFILES[p])`` for 'tp' and 'fsdp' on 4
    fake CPU devices, mesh (2, 2) (2 nodes x a model axis of 2), lm-tiny,
    DSE-MVR tau 3, one round, from the model's init plus 0.05 N(0, 1) (as
    ``test_torch_sharded_group.py`` draws them).  A 4-rank group (2 nodes x
    model 2) replays both from the same parameters and batches within the
    reference's band between its sharded job and its single-device path,
    rtol 5e-3 / atol 1e-4 (``tests/test_distributed.py``).
  * Model 2 against model 1: the same 2 nodes for ROUNDS rounds from seed
    0, the 4-rank group against one process at model 1.  With the engine's
    bf16 activations, lm-tiny (everything shards; under fsdp the node batch
    of 2 splits) in the same band, the loss within rtol 1e-3 and ``v_norm``
    within rtol 5e-3.  With fp32 activations (``Model.loss`` wrapped in
    the test: the engine asks for bf16), within rtol 1e-5 / atol 1e-6
    every round, lm-tiny and an odd variant: 2 layers, 6 heads on 3 KV
    heads (tp's KV heads fall back to replicated and each rank takes the KV
    heads of its 3 query heads, one each), QK norms and biases, an untied
    head and a node batch of 3 (fsdp's whole-batch fallback).  In bf16 the
    two layouts round differently (a rank's partial sums are rounded to
    bf16 before the fp32 all-reduce, as a bf16 Megatron layer rounds them):
    the odd variant's tp run lies 1.9e-4 from model 1 after one round on a
    CPU and drifts with the rounds, where fp32 agrees to 6e-8.  The
    tensor-parallel model alone: its fp32 loss and gradients equal the
    whole model's within 1e-5 of each leaf's largest gradient (both
    configs, on the 2-rank group).
  * Replicated leaves (the norms, the replicated KV heads' projections and
    the QK norms under tp; the QK norms and head biases under fsdp) hold the
    same bits on both model ranks of a node after every round, and the model group's byte counts
    show its movements (tp: all-reduces; fsdp: all-gathers and
    reduce-scatters).
  * A 2-rank group (1 node x model 2): every ``ALGORITHMS`` entry takes one
    fused step under each profile, and what a model axis once refused (a
    codec under the '2d' profile) builds a job and takes one finite round.
    The '2d' layout itself is ``test_torch_layout_2d.py``'s; tp over the
    MoE, Mamba-2 and RWKV blocks and HuBERT's encoder is
    ``test_torch_layout_blocks.py``'s; codecs, channels and scenarios on a
    model axis are ``test_torch_layout_codecs.py``'s, and under '2d'
    ``test_torch_layout_2d_codecs.py``'s.

Each group initializes from a ``FileStore`` under the test's temporary
directory; every process and the whole group have deadlines of their own,
so a hung gloo call fails its test.  Ranks run one torch thread each.
"""
import argparse
import contextlib
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
NODES, MODEL, TAU, ROUNDS, S, VOCAB = 2, 2, 3, 3, 16, 256
CFGS = {
    "tiny": dict(name="lm-tiny", arch_type="dense", n_layers=1, d_model=32, n_heads=4,
                 n_kv_heads=2, d_ff=64, vocab_size=VOCAB, block_unit=("attn",),
                 tie_embeddings=True),
    "odd": dict(name="lm-tiny-odd", arch_type="dense", n_layers=2, d_model=32, n_heads=6,
                n_kv_heads=3, head_dim=8, d_ff=64, vocab_size=VOCAB, block_unit=("attn",),
                tie_embeddings=False, qk_norm=True, use_bias=True),
}
BATCH = {"tiny": 2, "odd": 3}      # a node's batch: fsdp splits 2, not 3
RUNS = (("tiny", "bf16"), ("tiny", "fp32"), ("odd", "fp32"))   # (config, activations)
HYPER = dict(tau=TAU, lr=1e-2, alpha=0.1)
PROFILE_NAMES = ("tp", "fsdp")
ALGORITHM_NAMES = ("dlsgd", "dse_mvr", "dse_sgd", "dsgd", "gt_dsgd", "gt_hsgd", "pd_sgdm",
                   "slowmo_d")
# once-refused case -> make_train_job keywords: each now builds a job and
# takes a round (codecs, channels and scenarios on a model axis are
# test_torch_layout_codecs.py's)
REFUSALS = {
    "2d": dict(profile="2d", compression="qsgd"),
}
PROCESS_DEADLINE = 240     # s, one rank process
GROUP_DEADLINE = 300       # s, a whole group
REF_BAND = dict(rtol=5e-3, atol=1e-4)


# ------------------------------------------------------------ the rank side
def _batches(kind: str, seed: int, rounds: int = 1):
    rng = np.random.default_rng(seed)
    shape = (rounds, TAU, NODES, BATCH[kind], S)
    vocab = CFGS[kind]["vocab_size"]
    return {"tokens": rng.integers(0, vocab, shape), "targets": rng.integers(0, vocab, shape)}


def _numpy(tree):
    from repro_torch.tree import tree_leaves

    return [t.detach().cpu().numpy() for t in tree_leaves(tree)]


@contextlib.contextmanager
def fp32_activations():
    """``Model.loss`` in fp32 whatever dtype the engine asks for."""
    from repro_torch.models import Model

    loss = Model.loss
    Model.loss = lambda self, p, b, dtype=None, **kw: loss(self, p, b, torch.float32, **kw)
    try:
        yield
    finally:
        Model.loss = loss


def run_rounds(mesh, kind: str, profile: str, params=None, batches=None, rounds=ROUNDS,
               fp32=False):
    """``rounds`` rounds of a config on ``mesh`` (bf16 activations, or fp32
    ones): after each, the whole parameters (every node, gathered over both
    axes), this rank's shards, the metrics and the mesh's bytes."""
    if fp32:
        with fp32_activations():
            return run_rounds(mesh, kind, profile, params, batches, rounds)
    from repro_torch.launch.distributed import make_train_job
    from repro_torch.models import ModelConfig

    job = make_train_job(ModelConfig(**CFGS[kind]), mesh, profile=profile, **HYPER)
    state = job.init_state(0, params=params)
    batches = _batches(kind, 1, rounds) if batches is None else batches
    out = {"full": [], "local": [], "metrics": [], "shard_dims": job.shard_dims,
           "layout": job.state_layout.params}
    for r in range(rounds):
        mesh.reset_bytes()
        state, m = job.step_fn(state, job.local_batch({k: v[r] for k, v in batches.items()}))
        out["bytes"] = mesh.byte_counts()      # a round's, before the gather below
        out["full"].append(_numpy(job.full(state.params)))
        out["local"].append(_numpy(state.params))
        out["metrics"].append({k: float(v) for k, v in m.items()})
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


def main_group(mesh, ref_npz) -> dict:
    """The 4-rank group's runs: the reference replays and the model-2 runs."""
    from repro_torch.convert import params_from_numpy

    npz = np.load(ref_npz)
    batches = {k: npz[k].astype(np.int64)[None] for k in ("tokens", "targets")}
    init = params_from_numpy(_nest(npz, "init"), "cpu")
    out = {"reference": {}, "runs": {}}
    for p in PROFILE_NAMES:
        out["reference"][p] = run_rounds(mesh, "tiny", p, params=init, batches=batches,
                                         rounds=1)
        out["runs"][("tiny", p, "bf16")] = run_rounds(mesh, "tiny", p)
        for kind in CFGS:
            out["runs"][(kind, p, "fp32")] = run_rounds(mesh, kind, p, fp32=True)
    return out


def tp_against_whole(mesh, kind: str) -> float:
    """The fp32 loss and gradients of the tensor-parallel model on this
    rank's shards against the whole model's on one batch: the largest gap
    of the loss, relative, and of each leaf's gradient (this rank's part),
    relative to the leaf's max |gradient|."""
    from repro_torch.launch.distributed import make_train_job
    from repro_torch.models import ModelConfig
    from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

    cfg = ModelConfig(**CFGS[kind])
    job = make_train_job(cfg, mesh, profile="tp")
    whole, treedef = tree_flatten(job.model.init(0, device="cpu"))
    shards = [p[0] for p in tree_leaves(job.init_state(0).params)]
    rng = np.random.default_rng(3)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (BATCH[kind], S)))
             for k in ("tokens", "targets")}
    got = {}
    for tag, leaves, tp in (("whole", whole, None), ("tp", shards, mesh.model_group)):
        ps = [p.detach().clone().requires_grad_(True) for p in leaves]
        loss = job.model.loss(tree_unflatten(treedef, ps), batch, dtype=torch.float32, tp=tp)
        got[tag] = (float(loss.detach()), torch.autograd.grad(loss, ps))
    worst = abs(got["tp"][0] - got["whole"][0]) / abs(got["whole"][0])
    m = mesh.model_group.index
    for g, w, d in zip(got["tp"][1], got["whole"][1], job.shard_dims):
        if d is not None:
            n = w.shape[d] // MODEL
            w = w.narrow(d, m * n, n)
        worst = max(worst, float((g - w).abs().max() / w.abs().max()))
    return worst


def pair_group(mesh) -> dict:
    """The 2-rank group's cases: every algorithm under each profile, the
    tensor-parallel model in fp32, and the once-refused cases (each one's
    round: its loss and whether its parameters are finite)."""
    from repro_torch.launch.distributed import make_train_job
    from repro_torch.models import ModelConfig
    from repro_torch.scenarios import make_scenario

    cfg = ModelConfig(**CFGS["tiny"])
    out = {"algorithms": {}, "refusals": {},
           "tp_fp32": {kind: tp_against_whole(mesh, kind) for kind in CFGS}}
    rng = np.random.default_rng(2)
    for p in PROFILE_NAMES:
        for name in ALGORITHM_NAMES:
            job = make_train_job(cfg, mesh, algorithm=name, profile=p, use_fused=True, **HYPER)
            state = job.init_state(0)
            shape = (job.round_len, 1, 2, S)
            batches = {"tokens": rng.integers(0, VOCAB, shape),
                       "targets": rng.integers(0, VOCAB, shape)}
            state, m = job.step_fn(state, job.local_batch(batches))
            out["algorithms"][(name, p)] = {
                "round_len": job.round_len, "loss": float(m["loss"]),
                "finite": all(bool(np.isfinite(x).all()) for x in _numpy(state.params))}
    for case, kw in REFUSALS.items():
        kw = dict(kw)
        if "scenario" in kw:
            kw["scenario"] = make_scenario(kw["scenario"], seed=0)
        job = make_train_job(cfg, mesh, **HYPER, **kw)
        shape = (job.round_len, 1, 2, S)
        batches = {"tokens": rng.integers(0, VOCAB, shape),
                   "targets": rng.integers(0, VOCAB, shape)}
        state, m = job.step_fn(job.init_state(0), job.local_batch(batches))
        out["refusals"][case] = {
            "profile": job.profile.name, "loss": float(m["loss"]),
            "finite": all(bool(np.isfinite(x).all()) for x in _numpy(state.params))}
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
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(args.store, args.world),
                            rank=args.rank, world_size=args.world,
                            timeout=datetime.timedelta(seconds=PROCESS_DEADLINE))
    try:
        nodes = args.world // MODEL
        mesh = make_group_mesh(nodes, device="cpu", model=MODEL)
        res = main_group(mesh, args.ref) if args.ref else pair_group(mesh)
        res["mesh"] = {"world": mesh.world, "rank": mesh.rank, "model": mesh.model,
                       "index": mesh.model_group.index, "devices": mesh.devices.shape}
        torch.save(res, args.out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------- the parent side
def _spawn_group(world: int, tmp: Path, extra=(), script=__file__) -> list:
    """Run ``script`` (this file) as ``world`` rank processes; their
    results by rank."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    store = tmp / f"store{world}"
    procs, outs = [], []
    for r in range(world):
        out = tmp / f"rank{world}_{r}.pt"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, script, "--rank", str(r), "--world", str(world),
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
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.launch.distributed import make_train_job
from repro.launch.mesh import make_test_mesh
from repro.launch.sharding import PROFILES
from repro.models import ModelConfig

cfg = ModelConfig(**{cfg})
mesh = make_test_mesh(({nodes}, {model}), ("data", "model"))
rng = np.random.default_rng(0)
shape = ({tau}, {nodes}, {b}, {s})
res = {{"tokens": rng.integers(0, {vocab}, shape).astype(np.int32),
       "targets": rng.integers(0, {vocab}, shape).astype(np.int32)}}
p0 = None
for name in {profiles}:
    job = make_train_job(cfg, mesh, gossip="roll", profile=PROFILES[name], **{hyper})
    assert job.n_nodes == {nodes}
    if p0 is None:
        p0 = jax.tree.map(lambda x: np.asarray(x) + np.float32(0.05) * rng.standard_normal(
            x.shape).astype(np.float32), job.model.init(jax.random.key(0)))
        for k, v in jax.tree_util.tree_flatten_with_path(p0)[0]:
            res["init/" + jax.tree_util.keystr(k)] = v
    stacked = jax.tree.map(lambda p: jnp.broadcast_to(jnp.asarray(p)[None], ({nodes},) + p.shape),
                           p0)
    state = job.algorithm.init(stacked)
    step = jax.jit(job.step_fn, in_shardings=(job.state_shardings, job.batch_shardings),
                   out_shardings=(job.state_shardings, None))
    state, m = step(state, {{"tokens": jnp.asarray(res["tokens"]),
                            "targets": jnp.asarray(res["targets"])}})
    for k, v in jax.tree_util.tree_flatten_with_path(state.params)[0]:
        res[name + "/" + jax.tree_util.keystr(k)] = np.asarray(v)
    res[name + "_loss"] = np.asarray(m["loss"])
np.savez(sys.argv[1], **res)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's jobs, the model-1 runs in this process, the 4-rank
    group and the 2-rank group, run once for the module."""
    from repro_torch.launch.mesh import make_test_mesh

    tmp = tmp_path_factory.mktemp("layout")
    ref_npz = tmp / "reference.npz"
    env = reference_env(GROUP_DEADLINE, devices=NODES * MODEL)
    code = textwrap.dedent(REFERENCE.format(
        cfg=CFGS["tiny"], nodes=NODES, model=MODEL, tau=TAU, b=BATCH["tiny"], s=S, vocab=VOCAB,
        profiles=PROFILE_NAMES, hyper=HYPER))
    ref = subprocess.Popen([sys.executable, "-c", code, str(ref_npz)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        pair = _spawn_group(MODEL, tmp)
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            mesh = make_test_mesh(NODES, device="cpu")
            one = {(kind, fp32): run_rounds(mesh, kind, "tp", fp32=fp32 == "fp32")
                   for kind, fp32 in RUNS}
        finally:
            torch.set_num_threads(n)
        log = ref.communicate(timeout=GROUP_DEADLINE)[0]
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log[-4000:]
    group = _spawn_group(NODES * MODEL, tmp, ("--ref", str(ref_npz)))
    return {"one": one, "group": group, "pair": pair, "ref": np.load(ref_npz)}


def test_ranks_lay_out_data_by_model():
    """``NodeMesh`` at world 1 is the (1, 1) mesh the profiles read."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.sharding import PROFILES

    mesh = make_test_mesh(4, device="cpu")
    assert mesh.axis_names == ("data", "model") and mesh.devices.shape == (1, 1)
    assert mesh.model == 1 and mesh.model_group is None and "model" not in mesh.byte_counts()
    assert PROFILES["tp"].n_nodes(mesh) == 1 and PROFILES["2d"].node_axes(mesh) == ()


def test_group_ranks_are_data_major(runs):
    """Rank d M + m holds model shard m of node block d."""
    for r, res in enumerate(runs["group"]):
        assert res["mesh"] == {"world": NODES, "rank": r // MODEL, "model": MODEL,
                               "index": r % MODEL, "devices": (NODES, MODEL)}


@pytest.mark.parametrize("profile", PROFILE_NAMES)
def test_layout_matches_the_reference(runs, profile):
    """The 4-rank group replays the reference's (2, 2)-mesh job within
    rtol 5e-3 / atol 1e-4, its loss within rtol 1e-4."""
    from repro_torch.tree import tree_leaves

    ref = runs["ref"]
    want = [np.asarray(x) for x in tree_leaves(_nest(ref, profile))]
    for res in runs["group"]:
        got = res["reference"][profile]["full"][0]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **REF_BAND)
        np.testing.assert_allclose(res["reference"][profile]["metrics"][0]["loss"],
                                   float(ref[profile + "_loss"]), rtol=1e-4)


@pytest.mark.parametrize("run", RUNS, ids=["-".join(r) for r in RUNS])
@pytest.mark.parametrize("profile", PROFILE_NAMES)
def test_model_two_matches_model_one(runs, profile, run):
    """The same 2 nodes at model 2 and at model 1, every round: in bf16 the
    parameters in the reference's band, the loss within rtol 1e-3 and
    ``v_norm`` within rtol 5e-3; in fp32 all of them within rtol 1e-5 /
    atol 1e-6."""
    kind, act = run
    want = runs["one"][run]
    band = REF_BAND if act == "bf16" else dict(rtol=1e-5, atol=1e-6)
    for res in runs["group"]:
        got = res["runs"][(kind, profile, act)]
        for r in range(ROUNDS):
            for g, w in zip(got["full"][r], want["full"][r]):
                np.testing.assert_allclose(g, w, **band, err_msg=f"round {r + 1}")
            for k, rtol in (("loss", 1e-3), ("v_norm", 5e-3)):
                np.testing.assert_allclose(got["metrics"][r][k], want["metrics"][r][k],
                                           rtol=rtol if act == "bf16" else band["rtol"])


@pytest.mark.parametrize("kind", sorted(CFGS))
def test_tensor_parallel_model_is_the_whole_model_in_fp32(runs, kind):
    """In fp32, the tensor-parallel loss and each rank's gradients equal
    the whole model's within 1e-5 (relative to each leaf's largest)."""
    for res in runs["pair"]:
        assert res["tp_fp32"][kind] < 1e-5, (kind, res["tp_fp32"][kind])


@pytest.mark.parametrize("run", RUNS, ids=["-".join(r) for r in RUNS])
@pytest.mark.parametrize("profile", PROFILE_NAMES)
def test_shards_and_replicated_leaves(runs, profile, run):
    """Each rank holds its part of every sharded leaf of the gathered
    parameters; a replicated leaf holds the same bits on both model ranks
    of a node after every round."""
    group = runs["group"]
    kind = run[0]
    key = (kind, profile, run[1])
    dims = group[0]["runs"][key]["shard_dims"]
    assert any(d is not None for d in dims)
    if kind == "odd" or profile == "tp":
        assert any(d is None for d in dims)
    for r_i, res in enumerate(group):
        got = res["runs"][key]
        m = r_i % MODEL
        for rnd in range(ROUNDS):
            for leaf, (full, local, d) in enumerate(zip(got["full"][rnd], got["local"][rnd],
                                                        dims)):
                rows = full[(r_i // MODEL):(r_i // MODEL) + 1]
                if d is None:
                    twin = group[r_i - m]["runs"][key]["local"][rnd][leaf]
                    np.testing.assert_array_equal(local, twin)
                    np.testing.assert_array_equal(local, rows)
                else:
                    n = full.shape[d + 1] // MODEL
                    np.testing.assert_array_equal(
                        local, np.take(rows, range(m * n, (m + 1) * n), axis=d + 1))


@pytest.mark.parametrize("profile", PROFILE_NAMES)
def test_model_group_moves_what_the_profile_needs(runs, profile):
    """tp all-reduces activations and their gradients (no gather); fsdp
    gathers the parameters and reduce-scatters the gradients (its only
    all-reduces are the split batch's losses)."""
    for res in runs["group"]:
        moved = res["runs"][("tiny", profile, "bf16")]["bytes"]["model"]
        if profile == "tp":
            assert moved["all_reduce"] > 0 and moved["all_gather"] == 0
            assert moved["reduce_scatter"] == 0
        else:
            assert moved["all_gather"] > 0 and moved["reduce_scatter"] > 0
            assert 0 < moved["all_reduce"] < moved["reduce_scatter"]
        assert res["runs"][("tiny", profile, "bf16")]["bytes"]["roll"]["process"] > 0


@pytest.mark.parametrize("profile", PROFILE_NAMES)
@pytest.mark.parametrize("name", ALGORITHM_NAMES)
def test_every_algorithm_steps_under_each_profile(runs, name, profile):
    """One fused step of every algorithm on 1 node x model 2, finite and
    the same loss on both model ranks."""
    from repro_torch.core import ALGORITHMS

    assert set(ALGORITHMS) == set(ALGORITHM_NAMES)
    want_len = 1 if ALGORITHMS[name].comm.cadence == "every_step" else TAU
    got = [res["algorithms"][(name, profile)] for res in runs["pair"]]
    for res in got:
        assert res["round_len"] == want_len and res["finite"] and np.isfinite(res["loss"])
    assert got[0]["loss"] == got[1]["loss"]


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_model_axis_refusals(runs, case):
    """What a model axis once refused (ROADMAP queue 1 item 8 (b) 5: a codec
    under '2d') builds a job and takes one finite round, the same loss on
    both ranks."""
    got = [res["refusals"][case] for res in runs["pair"]]
    for res in got:
        assert res["profile"] == REFUSALS[case]["profile"]
        assert res["finite"] and np.isfinite(res["loss"]), res
        assert res["loss"] == got[0]["loss"]


if __name__ == "__main__":
    _rank_main()
