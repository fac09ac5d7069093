"""The '2d' sharding profile: ``make_train_job(profile="2d")`` on a pod x
data x model gloo mesh (``NodeMesh(data=D, model=M)``), against the
reference's '2d' job and against the whole model.

  * Against the reference: one subprocess runs the reference's
    ``make_train_job(..., profile=PROFILES["2d"])`` on 8 fake CPU devices,
    DSE-MVR tau 2, 2 rounds, from each config's init plus 0.05 N(0, 1), on
    numpy batches, through its jnp update path: reduced Arctic 480B and
    reduced Command R+ 104B on ``make_test_mesh((2, 2, 2), ("pod", "data",
    "model"))`` (2 nodes across 'pod', each data 2 x model 2), reduced
    Arctic at a capacity factor of 0.5 there (its queues drop entries), and
    reduced Arctic on the CLI's ``(4, 2)`` ``("data", "model")`` mesh, which
    '2d' makes one node of data 4 x model 2.  An 8-rank group replays them
    from the same parameters and batches: each round's loss, and every
    rank's shard of every leaf against its slice of the reference's leaf,
    within the reference's band between its sharded job and its
    single-device path, rtol 5e-3 / atol 1e-4 (``tests/test_distributed.py``).
    Both sides run fp32 activations (``Model.loss`` wrapped; the engines ask
    for bf16): in bf16 the reference's own layouts round apart past the
    band on a MoE (``tests/test_torch_layout_blocks.py``), which would
    measure rounding, not the layout.
  * The '2d' model against the whole one, in fp32 on one batch: the rank's
    shards gathered over the data group, ``Model.loss(..., tp=, data=)`` on
    the rank's rows -- its share of the whole batch's loss, whose sum over
    the data ranks is the whole loss -- and the gradients' sum over the data
    group reduce-scattered: the loss, Arctic's router losses, and every
    leaf's gradient (the rank's shard) within 1e-5 of the whole model's
    (relative to the leaf's largest gradient), also where the queues drop
    entries.  A node batch of 2 rows on the (4, 2) mesh does not split over
    its 4 data ranks: the engine's round there (each data rank computes the
    whole batch and keeps its shard) is the world-1 round's, in the band.
  * The layout: rank ``p D M + d M + m``; ``axis_names`` ``("pod", "data",
    "model")``; the resolved specs of every arch at full size the
    reference's, leaf for leaf; leaves replicated over the data or the model
    ranks the same bits on each; the data group's movements counted under
    ``byte_counts()["data"]``, ``sum_below`` in rank order.
  * Every ``ALGORITHMS`` entry takes one finite round of reduced Arctic in
    the engine's bf16, the same loss on all 8 ranks; a codec, a channel or
    a scenario under '2d' on a spread node, which ROADMAP queue 1 item 8
    (b) 5 once refused, builds a job there, each leaf's codec bound to its
    block (``test_torch_layout_2d_codecs.py`` trains them).

The group initializes from a ``FileStore`` under the test's temporary
directory (``test_torch_layout_group.py``'s spawn); every process and the
whole group have deadlines of their own, so a hung gloo call fails its
test.  Ranks run one torch thread each.
"""
import argparse
import dataclasses
import datetime
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _reference_env import reference_env  # noqa: E402
from test_torch_layout_group import (  # noqa: E402
    PROCESS_DEADLINE, _nest, _numpy, _spawn_group, fp32_activations,
)

WORLD, TAU, ROUNDS, B, S = 8, 2, 2, 4, 16
HYPER = dict(tau=TAU, lr=1e-2, alpha=0.1)
REF_BAND = dict(rtol=5e-3, atol=1e-4)
GRAD_TOL = 1e-5
UNSPLIT_B = 2   # a node batch that does not split over 4 data ranks
# case -> (arch, config change, (pod, data, model)); the reference's mesh is
# (pod, data, model) where pod > 1, else the CLI's (data, model)
CASES = {
    "arctic": ("arctic_480b", {}, (2, 2, 2)),
    "command_r": ("command_r_plus_104b", {}, (2, 2, 2)),
    "arctic_drops": ("arctic_480b", {"capacity_factor": 0.5}, (2, 2, 2)),
    "arctic_one_node": ("arctic_480b", {}, (1, 4, 2)),
}
WHOLE_CASES = ("arctic", "arctic_drops", "command_r")
ALGORITHM_NAMES = ("dlsgd", "dse_mvr", "dse_sgd", "dsgd", "gt_dsgd", "gt_hsgd", "pd_sgdm",
                   "slowmo_d")
ARCHS = ("arctic_480b", "command_r_plus_104b", "gemma2_2b", "hubert_xlarge", "minitron_8b",
         "qwen2_moe_a2_7b", "qwen2_vl_2b", "rwkv6_3b", "yi_9b", "zamba2_7b")
REFERENCE_DEADLINE = 300   # s, the reference's subprocess


def _config(case: str):
    from repro_torch.configs import get_reduced

    arch, change, _ = CASES[case]
    return dataclasses.replace(get_reduced(arch), **change)


def _part(x, dim, size, index):
    if dim is None:
        return x
    n = x.shape[dim] // size
    return x.narrow(dim, index * n, n).contiguous()


# ------------------------------------------------------------ the rank side
def replay(case: str, npz) -> dict:
    """The reference's rounds of ``case`` from its parameters and batches,
    fp32 activations: each round's loss, this rank's shards and the mesh's
    bytes, and the leaves' layout."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.distributed import make_train_job
    from repro_torch.launch.mesh import make_group_mesh

    pods, data, model = CASES[case][2]
    mesh = make_group_mesh(pods, device="cpu", model=model, data=data)
    job = make_train_job(_config(case), mesh, profile="2d", **HYPER)
    state = job.init_state(0, params=params_from_numpy(_nest(npz, case + "/init"), "cpu"))
    out = {"loss": [], "local": [], "bytes": []}
    with fp32_activations():
        for r in range(ROUNDS):
            batches = {k: torch.as_tensor(npz[f"{case}/batch/{k}"][r])
                       for k in ("tokens", "targets")}
            mesh.reset_bytes()
            state, m = job.step_fn(state, job.local_batch(batches))
            out["loss"].append(float(m["loss"]))
            out["local"].append(_numpy(state.params))
            out["bytes"].append(mesh.byte_counts())
    out.update(shard_dims=list(job.shard_dims), data_dims=list(job.data_dims),
               n_local=mesh.n_local, pod=mesh.rank, data=mesh.data_group.index,
               model=mesh.model_group.index, n_nodes=job.n_nodes, axes=mesh.axis_names,
               shape=tuple(mesh.devices.shape))
    return out


def against_whole(case: str) -> dict:
    """The '2d' model on this rank's shards and rows against the whole
    model on one batch of B rows, fp32: the loss's and the router losses'
    relative gaps and each leaf's largest gradient gap (the rank's shard of
    the data-reduced gradient) relative to the leaf's max |gradient|."""
    from repro_torch.launch.distributed import make_train_job
    from repro_torch.launch.mesh import make_group_mesh
    from repro_torch.tree import tree_flatten, tree_unflatten

    pods, data, model = CASES[case][2]
    cfg = _config(case)
    mesh = make_group_mesh(pods, device="cpu", model=model, data=data)
    job = make_train_job(cfg, mesh, profile="2d")
    tp, dg = mesh.model_group, mesh.data_group
    whole, treedef = tree_flatten(job.model.init(0, device="cpu"))
    rng = np.random.default_rng(5)
    whole = [w + 0.05 * torch.as_tensor(rng.standard_normal(tuple(w.shape)), dtype=w.dtype)
             for w in whole]
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)))
             for k in ("tokens", "targets")}
    mine = {k: _part(v, 0, dg.size, dg.index) for k, v in batch.items()}
    shards = [_part(_part(w, d, model, tp.index), dd, data, dg.index)
              for w, d, dd in zip(whole, job.shard_dims, job.data_dims)]

    def run(leaves, rows, **kw):
        ps = [p.detach().requires_grad_(True) for p in leaves]
        params = tree_unflatten(treedef, ps)
        with torch.enable_grad():
            _, aux = job.model.forward(params, rows, dtype=torch.float32, **kw)
            loss = job.model.loss(params, rows, dtype=torch.float32, **kw)
            grads = torch.autograd.grad(loss, ps, materialize_grads=True)
        return loss.detach(), aux.detach(), list(grads)

    w_loss, w_aux, w_grads = run(whole, batch)
    d_loss, d_aux, d_grads = run(dg.all_gather(shards, job.data_dims), mine, tp=tp, data=dg)
    d_grads = dg.reduce_scatter(d_grads, job.data_dims)
    d_loss, d_aux = dg.all_reduce(d_loss), dg.all_reduce(d_aux)
    want = [_part(_part(g, d, model, tp.index), dd, data, dg.index)
            for g, d, dd in zip(w_grads, job.shard_dims, job.data_dims)]
    return {"loss_gap": float(abs(d_loss - w_loss) / abs(w_loss)),
            "aux": (float(w_aux), float(d_aux)),
            "leaf_gaps": [float((a - b).abs().max()) / max(float(g.abs().max()), 1e-30)
                          for a, b, g in zip(d_grads, want, w_grads)]}


def unsplit() -> dict:
    """One DSE-MVR round of reduced Arctic on the CLI's (4, 2) mesh with a
    node batch of UNSPLIT_B rows, which does not split over the 4 data
    ranks (each computes all of it and keeps its shard of the gradient),
    against the same round at world 1, fp32 activations: both losses and
    the whole parameters' largest gap in the band."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.distributed import make_train_job
    from repro_torch.launch.mesh import make_group_mesh, make_test_mesh
    from repro_torch.tree import tree_leaves

    cfg = get_reduced("arctic_480b")
    jobs = [make_train_job(cfg, mesh, profile="2d", **HYPER)
            for mesh in (make_group_mesh(1, device="cpu", model=2, data=4),
                         make_test_mesh(1, device="cpu"))]
    rng = np.random.default_rng(3)
    shape = (jobs[0].round_len, 1, UNSPLIT_B, S)
    batches = {k: rng.integers(0, cfg.vocab_size, shape) for k in ("tokens", "targets")}
    out = {"loss": [], "params": []}
    with fp32_activations():
        for job in jobs:
            state, m = job.step_fn(job.init_state(0), job.local_batch(batches))
            out["loss"].append(float(m["loss"]))
            out["params"].append(tree_leaves(job.full(state.params) if job is jobs[0]
                                             else state.params))
    got, want = out.pop("params")
    out["gap"] = max(float(((a - b).abs() / (REF_BAND["atol"] + REF_BAND["rtol"] * b.abs()))
                           .max()) for a, b in zip(got, want))
    return out


def algorithms() -> dict:
    """One fused round of every algorithm on reduced Arctic, the engine's
    bf16 activations, on the (2, 2, 2) mesh."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.distributed import make_train_job
    from repro_torch.launch.mesh import make_group_mesh

    cfg = get_reduced("arctic_480b")
    mesh = make_group_mesh(2, device="cpu", model=2, data=2)
    rng = np.random.default_rng(2)
    out = {}
    for name in ALGORITHM_NAMES:
        job = make_train_job(cfg, mesh, algorithm=name, profile="2d", use_fused=True, **HYPER)
        shape = (job.round_len, 2, B, 8)
        batches = {k: rng.integers(0, cfg.vocab_size, shape) for k in ("tokens", "targets")}
        state, m = job.step_fn(job.init_state(0), job.local_batch(batches))
        out[name] = {"round_len": job.round_len, "loss": float(m["loss"]),
                     "finite": all(bool(np.isfinite(x).all()) for x in _numpy(state.params))}
    return out


# what a spread node once refused -> make_train_job keywords
SPREAD = {"codec": dict(compression="qsgd"), "channel": dict(channel="choco"),
          "scenario": dict(scenario="dropout_ring")}


def spread_jobs() -> dict:
    """A codec, a channel and a scenario under '2d' on the (2, 2, 2) mesh:
    the job each builds (nothing moves), its channel's codec bindings, the
    mesh axes its wire's layout names and its scenario."""
    from repro_torch.compression.base import AtShard
    from repro_torch.configs import get_reduced
    from repro_torch.launch.distributed import make_train_job
    from repro_torch.launch.mesh import make_group_mesh
    from repro_torch.scenarios import make_scenario
    from repro_torch.tree import tree_leaves

    mesh = make_group_mesh(2, device="cpu", model=2, data=2)
    out = {}
    for what, kw in SPREAD.items():
        kw = dict(kw)
        if "scenario" in kw:
            kw["scenario"] = make_scenario(kw["scenario"], seed=0)
        job = make_train_job(get_reduced("arctic_480b"), mesh, profile="2d", **HYPER, **kw)
        chan = job.algorithm.comm.resolved_channel()
        codec = None if chan is None else chan.compression
        bound = [] if codec is None or codec.is_identity else [
            codec.for_leaf(i).inner for i in range(len(job.shard_dims))]
        wire = job.state_layout.comp
        axes = set()
        for spec in ([] if wire is None else
                     [x for w in wire.wire if w is not None and "hat" in w
                      for x in tree_leaves(w["hat"])]):
            for entry in (spec if isinstance(spec, tuple) else (spec,)):
                axes.update(entry if isinstance(entry, tuple) else (entry,))
        out[what] = {
            "profile": job.profile.name, "channel": None if chan is None else chan.name,
            "node": chan is not None and chan.node is mesh.node_group,
            "scenario": job.scenario is not None, "wire_axes": sorted(axes - {None}),
            "both": sum(isinstance(b, AtShard) and b.shard.data_dim is not None
                        for b in bound)}
    return out


def layout() -> dict:
    """Where this rank sits on a (2, 2, 2) mesh, and ``sum_below`` of each
    data rank's global rank + 1."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_group_mesh

    mesh = make_group_mesh(2, device="cpu", model=2, data=2)
    x = torch.tensor([dist.get_rank() + 1.0, 1.0])
    mesh.reset_bytes()
    below = mesh.data_group.sum_below(x)
    return {"global": dist.get_rank(), "pod": mesh.rank, "data": mesh.data_group.index,
            "model": mesh.model_group.index, "lo": mesh.lo, "below": below.tolist(),
            "bytes": mesh.byte_counts()["data"]}


def _rank_main(argv=None) -> None:
    import torch.distributed as dist

    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--ref", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(args.store, args.world),
                            rank=args.rank, world_size=args.world,
                            timeout=datetime.timedelta(seconds=PROCESS_DEADLINE))
    try:
        npz = np.load(args.ref)
        res = {"layout": layout(), "spread": spread_jobs(),
               "cases": {case: replay(case, npz) for case in CASES},
               "whole": {case: against_whole(case) for case in WHOLE_CASES},
               "unsplit": unsplit(),
               "algorithms": algorithms()}
        torch.save(res, args.out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------- the parent side
REFERENCE = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_reduced
from repro.launch.distributed import make_train_job
from repro.launch.mesh import make_test_mesh
from repro.launch.sharding import PROFILES
from repro.models import Model

loss = Model.loss
Model.loss = lambda self, params, batch, dtype=None: loss(self, params, batch, jnp.float32)

rng = np.random.default_rng(0)
res = {{}}


def rounds(tag, cfg, mesh, p0, batch, n, **kw):
    job = make_train_job(cfg, mesh, gossip="roll", profile=PROFILES["2d"], **kw)
    assert job.n_nodes == n, (tag, job.n_nodes)
    stacked = jax.tree.map(lambda p: jnp.broadcast_to(jnp.asarray(p)[None], (n,) + p.shape), p0)
    state = job.algorithm.init(stacked)
    step = jax.jit(job.step_fn, in_shardings=(job.state_shardings, job.batch_shardings),
                   out_shardings=(job.state_shardings, None))
    for r in range(len(batch["tokens"])):
        state, m = step(state, {{k: jnp.asarray(v[r]) for k, v in batch.items()}})
        for k, v in jax.tree_util.tree_flatten_with_path(state.params)[0]:
            res[tag + "/round" + str(r) + "/" + jax.tree_util.keystr(k)] = np.asarray(v)
        res[tag + "/loss" + str(r)] = np.asarray(m["loss"])


for case, (arch, change, (pods, data, model)) in {cases}.items():
    cfg = dataclasses.replace(get_reduced(arch), **change)
    mesh = (make_test_mesh((pods, data, model), ("pod", "data", "model")) if pods > 1
            else make_test_mesh((data, model), ("data", "model")))
    shape = ({rounds}, {tau}, pods, {b}, {s})
    batch = {{k: rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
             for k in ("tokens", "targets")}}
    p0 = jax.tree.map(lambda x: np.asarray(x) + np.float32(0.05) * rng.standard_normal(
        x.shape).astype(np.float32), Model(cfg).init(jax.random.key(0)))
    for k, v in jax.tree_util.tree_flatten_with_path(p0)[0]:
        res[case + "/init/" + jax.tree_util.keystr(k)] = v
    for k, v in batch.items():
        res[case + "/batch/" + k] = v
    rounds(case, cfg, mesh, p0, batch, pods, **{hyper})
    if pods == 1:   # the same job on one device
        rounds(case + "/one", cfg, make_test_mesh((1, 1), ("data", "model")), p0, batch, 1,
               **{hyper})

# the one-pod fault: one DSGD step of lr 1 (the update is the gradient) on
# reduced Arctic, on the (4, 2) mesh and on one device
cfg = get_reduced("arctic_480b")
batch = {{k: rng.integers(0, cfg.vocab_size, (1, 1, 1, {b}, {s})).astype(np.int32)
         for k in ("tokens", "targets")}}
p0 = jax.tree.map(lambda x: np.asarray(x) + np.float32(0.05) * rng.standard_normal(
    x.shape).astype(np.float32), Model(cfg).init(jax.random.key(0)))
for k, v in jax.tree_util.tree_flatten_with_path(p0)[0]:
    res["fault/init/" + jax.tree_util.keystr(k)] = v
for tag, mesh in (("fault/mesh", make_test_mesh((4, 2), ("data", "model"))),
                  ("fault/one", make_test_mesh((1, 1), ("data", "model")))):
    rounds(tag, cfg, mesh, p0, batch, 1, algorithm="dsgd", tau=1, lr=1.0)
np.savez(sys.argv[1], **res)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's jobs (a subprocess), then the 8-rank group."""
    tmp = tmp_path_factory.mktemp("layout_2d")
    ref_npz = tmp / "reference.npz"
    code = textwrap.dedent(REFERENCE.format(cases=CASES, hyper=HYPER, rounds=ROUNDS, tau=TAU,
                                            b=B, s=S))
    ref = subprocess.run([sys.executable, "-c", code, str(ref_npz)],
                         env=reference_env(REFERENCE_DEADLINE, devices=WORLD),
                         capture_output=True, text=True, timeout=REFERENCE_DEADLINE)
    assert ref.returncode == 0, ref.stdout[-2000:] + ref.stderr[-4000:]
    return {"ref": np.load(ref_npz),
            "group": _spawn_group(WORLD, tmp, ("--ref", str(ref_npz)), script=__file__)}


def _reference_leaves_at(npz, prefix: str) -> list:
    from repro_torch.convert import params_from_numpy
    from repro_torch.tree import tree_leaves

    return [t.numpy() for t in tree_leaves(params_from_numpy(_nest(npz, prefix), "cpu"))]


def _reference_leaves(npz, tag: str, r: int) -> list:
    """The reference run ``tag``'s whole parameters after round r."""
    return _reference_leaves_at(npz, f"{tag}/round{r}")


class _Names(dict):
    """Key -> the key's path, read by ``_nest`` as an npz is."""

    @property
    def files(self):
        return list(self)


def _leaf_names(npz, prefix: str) -> list:
    """The leaves' key paths under ``prefix``, in the port's leaf order."""
    from repro_torch.tree import tree_leaves

    return tree_leaves(_nest(_Names({k: k[len(prefix) + 1:] for k in npz.files
                                     if k.startswith(prefix + "/")}), prefix))


def _held_to(case: str) -> str:
    """The reference run a case is held to: its job on the case's mesh, or,
    on one pod, the same job on one device (its job on a one-pod mesh with
    data and model axes loses some experts' gradients:
    ``test_the_references_one_pod_2d_job_loses_expert_gradients``)."""
    return case + "/one" if CASES[case][2][0] == 1 else case


@pytest.mark.parametrize("case", sorted(CASES))
def test_losses_match_the_reference(runs, case):
    want = [float(runs["ref"][f"{_held_to(case)}/loss{r}"]) for r in range(ROUNDS)]
    for res in runs["group"]:
        got = res["cases"][case]["loss"]
        np.testing.assert_allclose(got, want, **REF_BAND)
        assert got == runs["group"][0]["cases"][case]["loss"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_ranks_shards_match_the_reference(runs, case):
    """After each round, every rank's shard of every leaf is its slice of
    the reference's leaf (its nodes' rows, its data and model parts)."""
    pods, data, model = CASES[case][2]
    for r in range(ROUNDS):
        whole = _reference_leaves(runs["ref"], _held_to(case), r)
        for res in runs["group"]:
            got = res["cases"][case]
            assert got["n_nodes"] == pods and len(got["local"][r]) == len(whole)
            rows = slice(got["pod"] * got["n_local"], (got["pod"] + 1) * got["n_local"])
            for g, w, d, dd in zip(got["local"][r], whole, got["shard_dims"], got["data_dims"]):
                w = _part(_part(torch.as_tensor(w[rows]), None if d is None else d + 1, model,
                                got["model"]),
                          None if dd is None else dd + 1, data, got["data"]).numpy()
                assert g.shape == w.shape, (case, r, g.shape, w.shape)
                np.testing.assert_allclose(g, w, **REF_BAND)


def test_the_references_one_pod_2d_job_loses_expert_gradients(runs):
    """A caveat in the reference: its '2d' job on a one-pod mesh whose data
    and model axes both exceed 1 (here the CLI's (4, 2)) updates reduced
    Arctic's experts 2 and 3 (those on data ranks 2 and 3) by nothing in
    their gate and up projections -- their gradient is lost -- where the
    same job on one device, and on the (2, 2, 2) mesh above, does not.  One
    DSGD step of lr 1, whose update is the gradient; every other leaf (and
    experts 0 and 1) agrees within 1e-3 of its largest update (fp32
    summation orders: up to 5e-5).  The port's one-node run
    holds the one-device job (``_held_to``) and the (4, 2) job on every
    other leaf."""
    npz = runs["ref"]
    init = _reference_leaves_at(npz, "fault/init")
    got = [i - w for i, w in zip(init, _reference_leaves(npz, "fault/mesh", 0))]
    want = [i - w for i, w in zip(init, _reference_leaves(npz, "fault/one", 0))]
    names = _leaf_names(npz, "fault/init")
    off = sorted(n for n, a, b in zip(names, got, want)
                 if np.abs(a - b).max() > 1e-3 * np.abs(b).max())
    assert off == ["['blocks']['b0']['ffn']['w_gate']", "['blocks']['b0']['ffn']['w_up']"], off
    for n, a, b in zip(names, got, want):
        if n in off:   # (node, layer, expert, d, f)
            assert np.abs(a[0, :, 2:]).max() == 0
            assert (np.abs(b[0, :, 2:]).max(axis=(-2, -1)) > 0).all()
            np.testing.assert_allclose(a[0, :, :2], b[0, :, :2], rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("r", range(ROUNDS))
def test_the_one_node_run_holds_the_references_mesh_job_elsewhere(runs, r):
    """The one-node case against the reference's (4, 2) job itself, on
    every leaf but the two whose gradient that job loses."""
    whole = _reference_leaves(runs["ref"], "arctic_one_node", r)
    names = _leaf_names(runs["ref"], "arctic_one_node/init")
    _, data, model = CASES["arctic_one_node"][2]
    held = 0
    for res in runs["group"]:
        got = res["cases"]["arctic_one_node"]
        for g, w, n, d, dd in zip(got["local"][r], whole, names, got["shard_dims"],
                                  got["data_dims"]):
            if n.endswith("['ffn']['w_gate']") or n.endswith("['ffn']['w_up']"):
                continue
            w = _part(_part(torch.as_tensor(w), None if d is None else d + 1, model,
                            got["model"]), None if dd is None else dd + 1, data,
                      got["data"]).numpy()
            np.testing.assert_allclose(g, w, **REF_BAND)
            held += 1
    assert held == WORLD * (len(names) - 2)


@pytest.mark.parametrize("case", sorted(CASES))
def test_replicated_leaves_hold_the_same_bits(runs, case):
    """A leaf replicated over the data ranks holds the same bits on each
    data rank of a node (its gradient summed in rank order), and one
    replicated over the model ranks on each model rank; Arctic's embedding
    and its experts shard over both axes."""
    group = [res["cases"][case] for res in runs["group"]]
    key = {(g["pod"], g["data"], g["model"]): g for g in group}
    first = group[0]
    for g in group:
        for i, (d, dd) in enumerate(zip(first["shard_dims"], first["data_dims"])):
            if dd is None:
                assert np.array_equal(g["local"][-1][i], key[g["pod"], 0, g["model"]]["local"][-1][i])
            if d is None:
                assert np.array_equal(g["local"][-1][i], key[g["pod"], g["data"], 0]["local"][-1][i])
    both = sum(d is not None and dd is not None
               for d, dd in zip(first["shard_dims"], first["data_dims"]))
    assert both >= 4, (first["shard_dims"], first["data_dims"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_data_group_moves_and_counts(runs, case):
    """Each round a rank all-gathers its data-sharded leaves and
    reduce-scatters their gradients over the data group, which sums the
    node loss's shares; a MoE exchanges its queue counts (``sum_below``) and
    sums its expert counts; the model group all-reduces (tp)."""
    moe = CASES[case][0] == "arctic_480b"
    for res in runs["group"]:
        for moved in res["cases"][case]["bytes"]:
            data = moved["data"]
            assert data["all_gather"] > 0 and data["reduce_scatter"] > 0, data
            assert data["all_reduce"] > 0
            assert (data["sum_below"] > 0) == moe, data
            assert moved["model"]["all_reduce"] > 0
        pods = CASES[case][2][0]
        assert (res["cases"][case]["bytes"][0]["roll"]["process"] > 0) == (pods > 1)


def test_ranks_lay_out_pod_by_data_by_model(runs):
    """Rank p D M + d M + m: pod p's node, data index d, model index m;
    ``sum_below`` adds the lower data ranks' values in rank order and counts
    what it received."""
    for res in runs["group"]:
        lay = res["layout"]
        assert lay["global"] == (lay["pod"] * 2 + lay["data"]) * 2 + lay["model"]
        assert lay["lo"] == lay["pod"]
        below = sum(lay["pod"] * 4 + d * 2 + lay["model"] + 1 for d in range(lay["data"]))
        assert lay["below"] == [float(below), float(lay["data"])]
        assert lay["bytes"]["sum_below"] == 8
    for res in runs["group"]:
        got = res["cases"]["arctic"]
        assert got["axes"] == ("pod", "data", "model") and got["shape"] == (2, 2, 2)
        one = res["cases"]["arctic_one_node"]
        assert one["shape"] == (1, 4, 2) and one["n_nodes"] == 1


@pytest.mark.parametrize("case", WHOLE_CASES)
def test_the_2d_model_is_the_whole_model_in_fp32(runs, case):
    """In fp32 the data ranks' loss shares and router-loss shares sum to the
    whole model's, and every leaf's gradient (reduced over the data group,
    the rank's shard) is the whole model's, within 1e-5."""
    for res in runs["group"]:
        got = res["whole"][case]
        assert got["loss_gap"] <= GRAD_TOL, got["loss_gap"]
        assert max(got["leaf_gaps"]) <= GRAD_TOL, got["leaf_gaps"]
        w_aux, d_aux = got["aux"]
        if CASES[case][0] == "arctic_480b":
            assert w_aux > 0
        assert abs(d_aux - w_aux) <= GRAD_TOL * max(abs(w_aux), 1e-30), got["aux"]


def test_a_node_batch_that_does_not_split_is_computed_whole(runs):
    """A node batch of 2 rows on 4 data ranks: every data rank computes all
    of it and keeps its shard of the gradient, as the reference replicates
    such a batch over 'data'; the round is the world-1 round's, the loss
    within 1e-5 and every leaf in the band."""
    for res in runs["group"]:
        got = res["unsplit"]
        d_loss, w_loss = got["loss"]
        assert abs(d_loss - w_loss) <= GRAD_TOL * abs(w_loss), got["loss"]
        assert got["gap"] <= 1.0, got["gap"]


def test_each_profile_lays_the_cli_grid_out_as_nodes():
    """The CLI's (data, model) grid: its data rows are nodes under 'tp' and
    'fsdp', one node of data ranks under '2d' (nodes on 'pod' alone)."""
    from repro_torch.launch.sharding import PROFILES

    assert PROFILES["tp"].node_grid(4) == (4, None)
    assert PROFILES["fsdp"].node_grid(4) == (4, None)
    assert PROFILES["2d"].node_grid(4) == (1, 4)


@pytest.mark.parametrize("name", ALGORITHM_NAMES)
def test_every_algorithm_takes_a_round_under_2d(runs, name):
    from repro_torch.core import ALGORITHMS

    assert set(ALGORITHMS) == set(ALGORITHM_NAMES)
    want_len = 1 if ALGORITHMS[name].comm.cadence == "every_step" else TAU
    got = [res["algorithms"][name] for res in runs["group"]]
    for res in got:
        assert res["round_len"] == want_len and res["finite"] and np.isfinite(res["loss"])
        assert res["loss"] == got[0]["loss"]


@pytest.mark.parametrize("what", sorted(SPREAD))
def test_a_codec_channel_or_scenario_under_2d_raises(runs, what):
    """What ROADMAP queue 1 item 8 (b) 5 once refused on a node spread over
    data x model ranks builds a job on every rank of the (2, 2, 2) mesh: a
    codec binds each leaf split over both groups to its block (reduced
    Arctic's experts and embedding), a channel sums over the node's ranks
    and lays its wire out over 'pod', 'data' and 'model', a scenario is the
    job's."""
    for res in runs["group"]:
        got = res["spread"][what]
        assert got["profile"] == "2d"
        if what == "codec":
            assert got["channel"] == "sync" and got["node"] and got["both"] >= 4, got
        elif what == "channel":
            assert got["channel"] == "choco" and got["node"], got
            assert got["wire_axes"] == ["data", "model", "pod"], got
        else:
            assert got["scenario"] and got["channel"] is None, got


def test_a_data_axis_is_the_2d_layouts():
    """'tp' and 'fsdp' refuse a mesh with a data axis; '2d' on a model axis
    needs one where the node axis has more than one rank."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.distributed import make_train_job

    cfg = get_reduced("arctic_480b")
    for name in ("tp", "fsdp"):
        with pytest.raises(ValueError, match="'2d' profile's layout"):
            make_train_job(cfg, SimpleNamespace(n_nodes=2, model=2, data=2, world=1),
                           profile=name)
    with pytest.raises(ValueError, match="data axis"):
        make_train_job(cfg, SimpleNamespace(n_nodes=2, model=2, data=1, data_axis=False,
                                            world=2), profile="2d")


MESHES = {
    "pod2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "pod2x2x2": ((2, 2, 2), ("pod", "data", "model")),
    "4x2": ((4, 2), ("data", "model")),
}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_2d_specs_resolve_as_the_reference(arch, mesh):
    """``resolve_specs(Model.param_specs())`` under the '2d' training rules,
    the node-axis prefix included, equals the reference's at full size,
    leaf for leaf."""
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config as j_get_config
    from repro.launch.sharding import PROFILES as J_PROFILES
    from repro.models import Model as JModel
    from repro.models import axis_rules as j_axis_rules
    from repro.models import resolve_specs as j_resolve_specs
    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import PROFILES
    from repro_torch.models import Model
    from repro_torch.models.common import axis_rules, resolve_specs
    from repro_torch.tree import tree_leaves

    shape, names = MESHES[mesh]
    m = SimpleNamespace(axis_names=names, devices=SimpleNamespace(shape=shape))

    def norm(spec):
        return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)

    prof, j_prof = PROFILES["2d"], J_PROFILES["2d"]
    with axis_rules(prof.train_rules(m), m, param_rules=prof.train_param_rules(m)):
        got = [norm(s) for s in tree_leaves(resolve_specs(
            Model(get_config(arch)).param_specs(), prefix=(prof.node_axes(m) or None,)))]
    with j_axis_rules(j_prof.train_rules(m), m, param_rules=j_prof.train_param_rules(m)):
        want = [norm(s) for s in jax.tree.leaves(
            j_resolve_specs(JModel(j_get_config(arch)).param_specs(),
                            prefix=(j_prof.node_axes(m) or None,)),
            is_leaf=lambda s: isinstance(s, P))]
    assert got == want
    assert prof.n_nodes(m) == j_prof.n_nodes(m)


if __name__ == "__main__":
    _rank_main()
