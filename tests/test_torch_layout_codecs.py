"""Codecs, gossip channels and scenarios on a node spread over a model axis
(``make_train_job`` on ``NodeMesh(model=2)``), on spawned gloo groups,
against the whole leaf's codec, the reference's ``make_train_job`` and the
model-1 job.

  * Codec level, on a 2-rank group (1 node x model 2): qsgd (with and
    without ``scale``), top_k 0.1 (on values with exact ties, and ratio
    1.0), rand_k 0.1, low_rank 2 and error feedback, on leaves sharded on
    dim 0, sharded on a later dim (a (4, 6, 8) leaf on dim 2) and
    replicated: the payload gathered over the group, the decoded shard and
    the residual equal the whole leaf's bit for bit (low-rank within 1e-6 of
    the leaf's max); a replicated leaf moves nothing over the group.
  * Against the reference: one subprocess runs the reference's
    ``make_train_job`` on 4 fake CPU devices, mesh (2, 2), lm-tiny, DSE-MVR
    tau 3, one round from the model's init plus 0.05 N(0, 1) (as
    ``test_torch_sharded_group.py`` draws it), its channel key
    ``jax.random.key(1)``, in fp32 activations (in bf16 the two packages
    round apart, and a QSGD level or a top-k pick at its cut may flip); it
    also writes the codec seeds, rand-k's index draws and low-rank's
    sketches its key chain gives.  A 4-rank group (2
    nodes x model 2) replays each case with them injected
    (``comm_seed_fn``, ``index_draw``, ``sketch_draw``) within rtol 5e-3 /
    atol 1e-4 (the QSGD cases but for one-level flips on at most
    ``FLIP_BUDGET`` of a leaf's elements): sync qsgd under tp on the roll;
    CHOCO top_k 0.25 under fsdp
    on the neighbour wire; async:3 qsgd with overlap under tp; CHOCO top_k
    0.25 under ``dropout_ring`` on the allgather wire, tp; sync low_rank 2,
    tp; sync rand_k 0.25, fsdp.
  * Bit for bit at model 2 (the counterparts of the reference's
    ``test_compression.py``, ``test_gossip.py``, ``test_transport.py`` and
    ``test_distributed.py`` on its (4, 2) mesh): ``compression="identity"``,
    ``channel="sync"`` and ``channel="async:1"`` give the plain job's bits
    for all 8 ``ALGORITHMS``; the ``baseline`` scenario the plain step's;
    ``defer_roll`` the pre-rolled overlap's.
  * Every codec (with and without error feedback), channel (sync, choco,
    async, per-buffer; with and without overlap), wire (neighbour,
    allgather, dense) and scenario (``baseline``, ``exponential``,
    ``dropout_ring``) runs under tp and fsdp on both groups: finite, the
    same loss, send decisions and streams on every rank, replicated leaves
    the same bits on both model ranks of a node; on the 4-rank group, in
    fp32 activations, within rtol 5e-3 / atol 1e-4 of the same 2 nodes at
    model 1 (this process).
  * ``TrainJob.full_state`` gathers the whole state, the channel's wire
    state too (error feedback's residuals; CHOCO's and async's replicas,
    in-flight payloads, ages and send masks), written in the reference's
    format and read back into the model-1 job's state within the band.
  * Bytes: a round's node-link bytes at model 2, summed over the ranks,
    are the model-1 job's plus (M - 1) x (the replicated leaves' payload
    bytes, and QSGD's 4 B scale a sharded leaf) a message, to the byte
    (``compression/gossip.py``); the model group's ``payload`` bytes are
    the shared tensors' chunks; top_k 0.03125 moves at least 4x fewer
    node-link bytes than the uncompressed roll.

Each group initializes from a ``FileStore`` under the test's temporary
directory; every process and the whole group have deadlines of their own,
so a hung gloo call fails its test.  Ranks run one torch thread each.
"""
import argparse
import contextlib
import datetime
import math
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
NODES, MODEL, TAU, S, VOCAB, B = 2, 2, 3, 16, 256, 2
CFG = dict(name="lm-tiny", arch_type="dense", n_layers=1, d_model=32, n_heads=4,
           n_kv_heads=2, d_ff=64, vocab_size=VOCAB, block_unit=("attn",),
           tie_embeddings=True)
HYPER = dict(tau=TAU, lr=1e-2, alpha=0.1)
PROFILE_NAMES = ("tp", "fsdp")
ALGORITHM_NAMES = ("dlsgd", "dse_mvr", "dse_sgd", "dsgd", "gt_dsgd", "gt_hsgd", "pd_sgdm",
                   "slowmo_d")
PASSTHROUGH = {"identity": dict(compression="identity"), "sync": dict(channel="sync"),
               "async1": dict(channel="async:1")}
# case -> (make_train_job keywords, scenario preset or None)
MATRIX = {
    "qsgd": (dict(compression="qsgd"), None),
    "qsgd_raw": (dict(compression=("qsgd", False)), None),
    "top_k": (dict(compression="top_k:0.25"), None),
    "top_k_raw": (dict(compression=("top_k:0.25", False)), None),
    "rand_k": (dict(compression="rand_k:0.25"), None),
    "rand_k_raw": (dict(compression=("rand_k:0.25", False)), None),
    "low_rank": (dict(compression="low_rank:2"), None),
    "low_rank_raw": (dict(compression=("low_rank:2", False)), None),
    "qsgd_allgather": (dict(compression="qsgd", wire_mode="allgather"), None),
    "choco": (dict(channel="choco", compression="top_k:0.25"), None),
    "choco_overlap": (dict(channel="choco", compression="top_k:0.25", overlap=True), None),
    "choco_raw": (dict(channel="choco"), None),
    "choco_allgather": (dict(channel="choco", compression="qsgd", wire_mode="allgather"),
                        None),
    "choco_dense": (dict(channel="choco", compression="rand_k:0.25", wire_mode="dense"),
                    None),
    "async": (dict(channel="async:2", compression="top_k:0.25"), None),
    "async_overlap": (dict(channel="async:3", compression="qsgd", overlap=True), None),
    "per_buffer": (dict(channel={"params": "choco"}, compression="top_k:0.25"), None),
    "baseline": (dict(compression="qsgd"), "baseline"),
    "exponential": (dict(channel="choco", compression="top_k:0.25"), "exponential"),
    "dropout_ring": (dict(channel="async:3", compression="qsgd"), "dropout_ring"),
}
# reference case -> (profile, make_train_job keywords, scenario preset or None)
REF_CASES = {
    "sync_qsgd": ("tp", dict(compression="qsgd"), None),
    "choco_top_k": ("fsdp", dict(channel="choco", compression="top_k:0.25",
                                 wire_mode="neighbor"), None),
    "async_overlap": ("tp", dict(channel="async:3", compression="qsgd", overlap=True), None),
    "dropout_allgather": ("tp", dict(channel="choco", compression="top_k:0.25",
                                     wire_mode="allgather"), "dropout_ring"),
    "low_rank": ("tp", dict(compression="low_rank:2"), None),
    "rand_k": ("fsdp", dict(compression="rand_k:0.25"), None),
}
# wire-state case -> make_train_job keywords: error feedback's residuals,
# CHOCO's replicas with an in-flight top-k payload, async's with QSGD's
STATE_CASES = {
    "qsgd": dict(compression="qsgd"),
    "choco_overlap": dict(channel="choco", compression="top_k:0.25", overlap=True),
    "async_overlap": dict(channel="async:3", compression="qsgd", overlap=True),
    "choco_allgather": dict(channel="choco", compression="qsgd", wire_mode="allgather"),
}
# byte case -> (make_train_job keywords)
BYTE_CASES = {
    "plain": dict(),
    "qsgd": dict(compression="qsgd"),
    "top_k": dict(compression="top_k:0.03125"),
    "choco": dict(channel="choco", compression="top_k:0.25"),
}
PROCESS_DEADLINE = 300     # s, one rank process
GROUP_DEADLINE = 360       # s, a whole group
REF_BAND = dict(rtol=5e-3, atol=1e-4)
# QSGD's levels are floor(|x| L / s + u): an element within an fp32 rounding
# of a level boundary lands on the neighbouring level where the two
# packages' fp32 gradients round apart (test_torch_compression.py's
# FLIP_BUDGET).  Against the reference, QSGD runs hold the band but for at
# most this share of a leaf's elements, each within one level of the
# leaf's scale (2 max|x| / L)
FLIP_BUDGET = 1e-4
# the whole state's in-flight payloads against model 1's (fp32): entries at
# the top-k cut whose |x - x̂| ties to within the layouts' fp32 rounding pick
# apart, and QSGD levels flip; the share of a payload tensor that must agree
FLY_SHARE = 0.99


# ------------------------------------------------------------ the rank side
def _batches(seed: int, rounds: int = 1, tau: int = TAU):
    rng = np.random.default_rng(seed)
    shape = (rounds, tau, NODES, B, S)
    return {"tokens": rng.integers(0, VOCAB, shape), "targets": rng.integers(0, VOCAB, shape)}


def _numpy(tree):
    from repro_torch.tree import tree_leaves

    return [t.detach().cpu().numpy() for t in tree_leaves(tree)]


@contextlib.contextmanager
def fp32_activations():
    """``Model.loss`` in fp32 whatever dtype the engine asks for."""
    from repro_torch.models import Model

    loss = Model.loss
    Model.loss = lambda self, p, b, dtype=None, tp=None: loss(self, p, b, torch.float32, tp)
    try:
        yield
    finally:
        Model.loss = loss


def _kwargs(kw):
    """Job keywords with a ``(spec, error_feedback)`` codec resolved."""
    from repro_torch.compression import make_compressor

    kw = dict(kw)
    if isinstance(kw.get("compression"), tuple):
        spec, ef = kw["compression"]
        kw["compression"] = make_compressor(spec, error_feedback=ef)
    return kw


def run_job(mesh, kw, scenario=None, profile="tp", rounds=1, params=None, batches=None,
            fp32=False, seed_fn=None, defer_roll=False, state_out=None):
    """``rounds`` rounds of lm-tiny on ``mesh``: after the last, the whole
    parameters (every node, gathered over both axes), this rank's shards,
    each round's metrics, the last round's bytes, the shard dims and the
    channel's last send masks.  ``state_out``: a directory where rank 0
    saves the whole state (``TrainJob.full_state``, the reference's
    format), or a list the final state is appended to."""
    if fp32:
        with fp32_activations():
            return run_job(mesh, kw, scenario, profile, rounds, params, batches,
                           seed_fn=seed_fn, defer_roll=defer_roll, state_out=state_out)
    import dataclasses

    from repro_torch.launch.distributed import make_train_job
    from repro_torch.models import ModelConfig
    from repro_torch.scenarios import make_scenario

    cfg = ModelConfig(**CFG)
    scen = None if scenario is None else make_scenario(scenario, seed=0)
    job = make_train_job(cfg, mesh, profile=profile, scenario=scen, comm_seed_fn=seed_fn,
                         **HYPER, **_kwargs(kw))
    if defer_roll:
        alg = job.algorithm
        chan = alg.comm.resolved_channel()
        assert chan.overlap and not chan.defer_roll and chan.neighbor_shifts
        alg = dataclasses.replace(alg, channel=dataclasses.replace(chan, defer_roll=True))
        job = make_train_job(cfg, mesh, algorithm=alg, profile=profile, scenario=scen,
                             comm_seed_fn=seed_fn, **HYPER)
    state = job.init_state(0, params=params)
    batches = _batches(1, rounds, job.round_len) if batches is None else batches
    sched = job.schedule_for(rounds) if scen is not None else None
    out = {"metrics": [], "shard_dims": job.shard_dims}
    for r in range(rounds):
        mesh.reset_bytes()
        local = job.local_batch({k: v[r] for k, v in batches.items()})
        if sched is None:
            state, m = job.step_fn(state, local)
        else:
            state, m = job.step_fn(state, local, job.round_ctx(sched, r))
        out["bytes"] = mesh.byte_counts()
        out["metrics"].append({k: float(v) for k, v in m.items()})
    out["full"] = _numpy(job.full(state.params))
    out["local"] = _numpy(state.params)
    if isinstance(state_out, list):
        state_out.append(state)
    elif state_out is not None:
        from repro_torch.checkpoint import save_checkpoint

        whole = job.full_state(state)       # every rank takes part
        if mesh.rank == 0 and mesh.model_group.index == 0:
            save_checkpoint(str(state_out), rounds, whole)
    comp = getattr(state, "comp", None)
    out["sent"] = ([w["sent"].cpu().numpy() for w in comp.wire
                    if isinstance(w, dict) and "sent" in w] if comp is not None else [])
    return out


def codec_level(group) -> dict:
    """Each codec on each leaf kind: the sharded encode against the whole
    leaf's, on this rank (module docstring)."""
    from repro_torch.compression.base import AtShard, ErrorFeedback, Shard
    from repro_torch.compression.compressors import LowRank, QSGD, RandK, TopK

    codecs = {"qsgd": (QSGD(), None), "qsgd_scale": (QSGD(), 0.5),
              "top_k": (TopK(0.1), None), "top_k_ties": (TopK(0.1), None),
              "top_k_all": (TopK(1.0), None), "top_k_scale": (TopK(0.1), 0.5),
              "rand_k": (RandK(0.1), None), "low_rank": (LowRank(2), None)}
    leaves = {"dim0": ((8, 6), 0), "dim2": ((4, 6, 8), 2), "rep": ((6, 5), None)}
    out = {}
    n = 3
    for ci, (cname, (codec, scale)) in enumerate(codecs.items()):
        for li, (lname, (whole, dim)) in enumerate(leaves.items()):
            rng = np.random.default_rng(100 * ci + li)
            x = rng.standard_normal((n,) + whole).astype(np.float32)
            if cname == "top_k_ties":
                x = np.round(x * 2) / 2          # exact ties, zeros and -0.0
                x[x == 0] = -0.0
            xw = torch.from_numpy(x)
            seed = 1234 + li
            codec_w = codec.at_rows(5)
            pw = codec_w.encode(xw, seed, scale=scale)
            dw = codec_w.decode(pw)
            if dim is None:
                before = group.byte_counts()
                ps = codec_w.encode(xw, seed, scale=scale)
                ds = codec_w.decode(ps)
                whole_p = ps
                moved = {k: group.byte_counts()[k] - before[k] for k in before}
                want_d = dw
            else:
                sh = Shard(group, dim, whole)
                bound = AtShard(inner=codec_w, shard=sh)
                xs = xw.narrow(dim + 1, sh.lo, sh.n).contiguous()
                ps = bound.encode(xs, seed, scale=scale)
                ds = bound.decode(ps)
                whole_p = bound.whole(ps)
                moved = None
                want_d = dw.narrow(dim + 1, sh.lo, sh.n)
            res = {"moved": moved, "decoded": bool(torch.equal(ds, want_d)),
                   "decoded_bits": bool(torch.equal(ds.view(torch.int32),
                                                    want_d.contiguous().view(torch.int32)))}
            gaps = {}
            for k, v in pw.data.items():
                g = whole_p.data[k]
                if cname == "low_rank":
                    gaps[k] = float((g.float() - v.float()).abs().max()
                                    / max(float(xw.abs().max()), 1e-30))
                else:
                    gaps[k] = bool(g.shape == v.shape and torch.equal(g, v))
            if cname == "low_rank":
                gaps["decoded"] = float((ds - want_d).abs().max() / xw.abs().max())
            res["payload"] = gaps
            out[(cname, lname)] = res
    # error feedback: the residual of the shard is the whole leaf's shard
    for cname, codec in (("ef_qsgd", QSGD()), ("ef_top_k", TopK(0.1))):
        ef = ErrorFeedback(inner=codec)
        rng = np.random.default_rng(7)
        tree = {"a": torch.from_numpy(rng.standard_normal((n, 4, 6, 8)).astype(np.float32)),
                "b": torch.from_numpy(rng.standard_normal((n, 6, 5)).astype(np.float32))}
        resid = {k: torch.from_numpy(0.1 * rng.standard_normal(v.shape).astype(np.float32))
                 for k, v in tree.items()}
        seeds = lambda leaf: 77 + leaf  # noqa: E731
        _, dec_w, res_w = ef.roundtrip(tree, resid, seeds)
        sh = Shard(group, 2, (4, 6, 8))
        bound = ef.at_shards([sh, None])
        part = {"a": tree["a"].narrow(3, sh.lo, sh.n).contiguous(), "b": tree["b"]}
        rpart = {"a": resid["a"].narrow(3, sh.lo, sh.n).contiguous(), "b": resid["b"]}
        _, dec_s, res_s = bound.roundtrip(part, rpart, seeds)
        out[(cname, "residual")] = {
            "decoded": bool(torch.equal(dec_s["a"], dec_w["a"].narrow(3, sh.lo, sh.n))
                            and torch.equal(dec_s["b"], dec_w["b"])),
            "residual": bool(torch.equal(res_s["a"], res_w["a"].narrow(3, sh.lo, sh.n))
                             and torch.equal(res_s["b"], res_w["b"]))}
    return out


def passthrough_runs(mesh) -> dict:
    """One step of every algorithm, plain and with each pass-through
    channel, under tp: the final shards' bits."""
    from repro_torch.launch.distributed import make_train_job
    from repro_torch.models import ModelConfig

    out = {}
    rng = np.random.default_rng(2)
    for name in ALGORITHM_NAMES:
        batches = None
        for tag, kw in (("plain", {}),) + tuple(PASSTHROUGH.items()):
            job = make_train_job(ModelConfig(**CFG), mesh, algorithm=name, profile="tp",
                                 **HYPER, **kw)
            if batches is None:
                shape = (job.round_len, NODES // mesh.world * mesh.world, B, S)
                batches = {"tokens": rng.integers(0, VOCAB, shape),
                           "targets": rng.integers(0, VOCAB, shape)}
            state, m = job.step_fn(job.init_state(0), job.local_batch(batches))
            out[(name, tag)] = {"local": _numpy(state.params),
                                "metrics": {k: float(v) for k, v in m.items()}}
    return out


def matrix_runs(mesh, fp32: bool) -> dict:
    return {(case, p): run_job(mesh, kw, scenario=scen, profile=p, fp32=fp32)
            for case, (kw, scen) in MATRIX.items() for p in PROFILE_NAMES}


def scenario_against_plain(mesh) -> dict:
    """The ``baseline`` scenario against the static job, QSGD and CHOCO."""
    out = {}
    for tag, kw in (("qsgd", dict(compression="qsgd")),
                    ("choco", dict(channel="choco", compression="top_k:0.25"))):
        out[tag] = {"static": run_job(mesh, kw, rounds=2),
                    "baseline": run_job(mesh, kw, scenario="baseline", rounds=2)}
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


class ReferenceDraws:
    """The reference's codec seeds, rand-k index draws and low-rank sketches
    of its one event, read from its npz."""

    def __init__(self, npz):
        self.seeds = npz["seeds"]                   # (buffers, leaves) uint32
        self.index = {int(s): npz[f"index/{int(s)}"] for s in self.seeds.reshape(-1)
                      if f"index/{int(s)}" in npz.files}
        self.sketch = {int(s): npz[f"sketch/{int(s)}"] for s in self.seeds.reshape(-1)
                       if f"sketch/{int(s)}" in npz.files}

    def seed_fn(self, e, b, leaf):
        assert e == 0, e
        return int(self.seeds[b, leaf])

    def index_draw(self, seed, d, k):
        got = torch.from_numpy(self.index[int(seed)].astype(np.int64))
        assert got.shape == (k,), (got.shape, d, k)
        return got

    def sketch_draw(self, seed, rows, cols):
        got = torch.from_numpy(self.sketch[int(seed)])
        assert got.shape == (rows, cols)
        return got


def reference_replays(mesh, npz) -> dict:
    """Each reference case replayed from its parameters, batches and
    draws."""
    from repro_torch.compression import make_compressor
    from repro_torch.compression.compressors import LowRank, RandK
    from repro_torch.convert import params_from_numpy

    draws = ReferenceDraws(npz)
    batches = {k: npz[k].astype(np.int64)[None] for k in ("tokens", "targets")}
    init = params_from_numpy(_nest(npz, "init"), "cpu")
    out = {}
    for case, (profile, kw, scen) in REF_CASES.items():
        kw = dict(kw)
        comp = kw.get("compression", "")
        if comp.startswith("rand_k"):
            kw["compression"] = make_compressor(RandK(0.25, index_draw=draws.index_draw),
                                                error_feedback=True)
        elif comp.startswith("low_rank"):
            kw["compression"] = make_compressor(LowRank(2, sketch_draw=draws.sketch_draw),
                                                error_feedback=True)
        out[case] = run_job(mesh, kw, scenario=scen, profile=profile, params=init,
                            batches=batches, seed_fn=draws.seed_fn, fp32=True)
    return out


def pair_group(mesh) -> dict:
    return {"codec": codec_level(mesh.model_group), "passthrough": passthrough_runs(mesh),
            "matrix": matrix_runs(mesh, fp32=False),
            "scenario": scenario_against_plain(mesh)}


def main_group(mesh, ref_npz) -> dict:
    states = Path(ref_npz).parent / "states"
    for case, kw in STATE_CASES.items():
        run_job(mesh, kw, rounds=2, fp32=True, state_out=states / case)
    return {"reference": reference_replays(mesh, np.load(ref_npz)),
            "matrix": matrix_runs(mesh, fp32=True),
            "bytes": {case: run_job(mesh, kw) for case, kw in BYTE_CASES.items()},
            "defer": {d: run_job(mesh, dict(channel="choco", compression="top_k:0.25",
                                            overlap=True), rounds=2, defer_roll=d)
                      for d in (False, True)},
            "scenario": scenario_against_plain(mesh)}


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
        mesh = make_group_mesh(args.world // MODEL, device="cpu", model=MODEL)
        res = main_group(mesh, args.ref) if args.ref else pair_group(mesh)
        res["mesh"] = {"rank": mesh.rank, "index": mesh.model_group.index}
        torch.save(res, args.out)
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
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.compression.base import attach_channel_state
from repro.launch.distributed import make_train_job
from repro.launch.mesh import make_test_mesh
from repro.launch.sharding import PROFILES
from repro.models import Model, ModelConfig
from repro.scenarios import make_scenario

# fp32 activations, as the port's replay runs them: in bf16 the packages'
# roundings differ, and a QSGD level or a top-k pick at its cut may flip
loss = Model.loss
Model.loss = lambda self, p, b, dtype=None: loss(self, p, b, jnp.float32)
cfg = ModelConfig(**{cfg})
mesh = make_test_mesh(({nodes}, {model}), ("data", "model"))
rng = np.random.default_rng(0)
shape = ({tau}, {nodes}, {b}, {s})
res = {{"tokens": rng.integers(0, {vocab}, shape).astype(np.int32),
       "targets": rng.integers(0, {vocab}, shape).astype(np.int32)}}
chan_key = jax.random.key(1)
p0 = None
for case, (profile, kw, scen) in {cases}.items():
    scenario = None if scen is None else make_scenario(scen, seed=0)
    job = make_train_job(cfg, mesh, gossip="roll", profile=PROFILES[profile],
                         scenario=scenario, **{hyper}, **kw)
    if p0 is None:
        p0 = jax.tree.map(lambda x: np.asarray(x) + np.float32(0.05) * rng.standard_normal(
            x.shape).astype(np.float32), job.model.init(jax.random.key(0)))
        for k, v in jax.tree_util.tree_flatten_with_path(p0)[0]:
            res["init/" + jax.tree_util.keystr(k)] = v
        # the key chain of event 0: split, fold in the buffer, fold in the leaf
        use, _ = jax.random.split(chan_key)
        shapes = [x.shape for x in jax.tree.leaves(p0)]
        seeds = np.zeros((2, len(shapes)), np.uint32)
        for b in range(2):
            kb = jax.random.fold_in(use, b)
            for leaf, shp in enumerate(shapes):
                key = jax.random.fold_in(kb, leaf)
                d = np.asarray(jax.random.key_data(key)).astype(np.uint32).reshape(-1)
                seed = int(d[0] ^ d[-1])
                seeds[b, leaf] = seed
                n = int(np.prod(shp))
                k = max(1, min(n, int(np.ceil(0.25 * n))))
                res["index/%d" % seed] = np.asarray(
                    jax.random.choice(key, n, shape=(k,), replace=False))
                if len(shp) >= 2:
                    nn = int(np.prod(shp[1:]))
                    r = min(2, shp[0], nn)
                    if r >= 1 and (shp[0] + nn) * r < shp[0] * nn:
                        res["sketch/%d" % seed] = np.asarray(
                            jax.random.normal(key, (nn, r), jnp.float32))
        res["seeds"] = seeds
    stacked = jax.tree.map(lambda p: jnp.broadcast_to(jnp.asarray(p)[None],
                                                      ({nodes},) + p.shape), p0)
    state = attach_channel_state(job.algorithm, job.algorithm.init(stacked), chan_key)
    batches = {{"tokens": jnp.asarray(res["tokens"]), "targets": jnp.asarray(res["targets"])}}
    if scenario is None:
        state, m = jax.jit(job.step_fn)(state, batches)
    else:
        ctx = job.round_ctx(job.schedule_for(1), 0)
        state, m = jax.jit(job.step_fn)(state, batches, ctx)
    for k, v in jax.tree_util.tree_flatten_with_path(state.params)[0]:
        res[case + "/" + jax.tree_util.keystr(k)] = np.asarray(v)
    res[case + "_loss"] = np.asarray(m["loss"])
np.savez(sys.argv[1], **res)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's jobs, the 2-rank group, the model-1 runs in this
    process and the 4-rank group, run once for the module."""
    from repro_torch.launch.mesh import make_test_mesh

    tmp = tmp_path_factory.mktemp("layout_codecs")
    ref_npz = tmp / "reference.npz"
    env = reference_env(GROUP_DEADLINE, devices=NODES * MODEL)
    code = textwrap.dedent(REFERENCE.format(
        cfg=CFG, nodes=NODES, model=MODEL, tau=TAU, b=B, s=S, vocab=VOCAB, hyper=HYPER,
        cases=REF_CASES))
    ref = subprocess.Popen([sys.executable, "-c", code, str(ref_npz)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        pair = _spawn_group(MODEL, tmp)
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            mesh = make_test_mesh(NODES, device="cpu")
            states = {}
            for case, kw in STATE_CASES.items():
                kept = []
                run_job(mesh, kw, rounds=2, fp32=True, state_out=kept)
                states[case] = kept[0]
            one = {"matrix": {case: run_job(mesh, kw, scenario=scen, fp32=True)
                              for case, (kw, scen) in MATRIX.items()},
                   "bytes": {case: run_job(mesh, kw) for case, kw in BYTE_CASES.items()},
                   "states": states}
        finally:
            torch.set_num_threads(n)
        log = ref.communicate(timeout=GROUP_DEADLINE)[0]
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log[-4000:]
    group = _spawn_group(NODES * MODEL, tmp, ("--ref", str(ref_npz)))
    return {"one": one, "group": group, "pair": pair, "ref": np.load(ref_npz),
            "states": tmp / "states"}


def _codec_cases():
    names = ("qsgd", "qsgd_scale", "top_k", "top_k_ties", "top_k_all", "top_k_scale",
             "rand_k", "low_rank")
    return [(c, leaf) for c in names for leaf in ("dim0", "dim2", "rep")]


@pytest.mark.parametrize("codec,leaf", _codec_cases())
def test_sharded_codec_is_the_whole_leafs(runs, codec, leaf):
    """The payload gathered over the group and the decoded shard are the
    whole leaf's, bit for bit (low-rank within 1e-6 of the leaf's max); a
    replicated leaf is encoded whole with no group traffic."""
    for res in runs["pair"]:
        got = res["codec"][(codec, leaf)]
        if codec == "low_rank":
            assert max(got["payload"].values()) < 1e-6, got
        else:
            assert got["decoded"] and got["decoded_bits"], got
            assert all(got["payload"].values()), got
        if leaf == "rep":
            assert not any(got["moved"].values()), got["moved"]


@pytest.mark.parametrize("codec", ["ef_qsgd", "ef_top_k"])
def test_error_feedback_keeps_the_shard_of_the_whole_residual(runs, codec):
    for res in runs["pair"]:
        assert runs and res["codec"][(codec, "residual")] == {"decoded": True,
                                                              "residual": True}


@pytest.mark.parametrize("case", sorted(REF_CASES))
def test_layout_codecs_match_the_reference(runs, case):
    """The 4-rank group replays the reference's (2, 2)-mesh job within
    rtol 5e-3 / atol 1e-4, its loss within rtol 1e-4."""
    from repro_torch.tree import tree_leaves

    ref = runs["ref"]
    want = [np.asarray(x) for x in tree_leaves(_nest(ref, case))]
    qsgd = "qsgd" in REF_CASES[case][1].get("compression", "")
    for res in runs["group"]:
        got = res["reference"][case]
        assert len(got["full"]) == len(want)
        for g, w in zip(got["full"], want):
            if not qsgd:
                np.testing.assert_allclose(g, w, **REF_BAND)
                continue
            out = ~np.isclose(g, w, **REF_BAND)
            assert out.mean() <= FLIP_BUDGET, (out.sum(), out.size)
            assert (np.abs(g - w)[out] <= 2 * np.abs(w).max() / 127).all()
        np.testing.assert_allclose(got["metrics"][0]["loss"], float(ref[case + "_loss"]),
                                   rtol=1e-4)


@pytest.mark.parametrize("tag", sorted(PASSTHROUGH))
@pytest.mark.parametrize("name", ALGORITHM_NAMES)
def test_passthrough_channels_are_the_plain_job(runs, name, tag):
    """identity, sync and async:1 give the plain job's bits at model 2."""
    for res in runs["pair"]:
        want = res["passthrough"][(name, "plain")]
        got = res["passthrough"][(name, tag)]
        for g, w in zip(got["local"], want["local"]):
            np.testing.assert_array_equal(g, w)
        assert got["metrics"] == want["metrics"]


@pytest.mark.parametrize("codec", ["qsgd", "choco"])
@pytest.mark.parametrize("group", ["pair", "group"])
def test_baseline_scenario_is_the_static_step(runs, group, codec):
    for res in runs[group]:
        got = res["scenario"][codec]
        for g, w in zip(got["baseline"]["local"], got["static"]["local"]):
            np.testing.assert_array_equal(g, w)
        for m_b, m_s in zip(got["baseline"]["metrics"], got["static"]["metrics"]):
            assert m_b["loss"] == m_s["loss"] and m_b["v_norm"] == m_s["v_norm"]


def test_defer_roll_is_the_pre_rolled_overlap(runs):
    for res in runs["group"]:
        for g, w in zip(res["defer"][True]["local"], res["defer"][False]["local"]):
            np.testing.assert_array_equal(g, w)
        assert res["defer"][True]["bytes"]["roll"]["node_link"] > 0


def _same_on_model_ranks(group, key):
    """Per node block, the model ranks' runs of ``key``: the same loss,
    streams and send masks, replicated leaves the same bits."""
    for base in range(0, len(group), MODEL):
        runs_ = [group[base + m]["matrix"][key] for m in range(MODEL)]
        first = runs_[0]
        for other in runs_[1:]:
            assert other["metrics"][0].keys() == first["metrics"][0].keys()
            for a, b in zip(other["metrics"], first["metrics"]):
                np.testing.assert_array_equal([a[k] for k in sorted(a)],
                                              [b[k] for k in sorted(b)])
            for a, b in zip(other["sent"], first["sent"]):
                np.testing.assert_array_equal(a, b)
            for a, b, d in zip(other["local"], first["local"], first["shard_dims"]):
                if d is None:
                    np.testing.assert_array_equal(a, b)
        for leaf in first["full"]:
            assert np.isfinite(leaf).all()


@pytest.mark.parametrize("profile", PROFILE_NAMES)
@pytest.mark.parametrize("case", sorted(MATRIX))
def test_every_wire_runs_on_a_model_axis(runs, case, profile):
    """Each codec, channel, wire and scenario on 1 node x model 2 and 2
    nodes x model 2: finite, the same on both model ranks of a node; on 2
    nodes (fp32 activations) within the band of model 1's."""
    for group in ("pair", "group"):
        _same_on_model_ranks(runs[group], (case, profile))
    want = runs["one"]["matrix"][case]
    for res in runs["group"]:
        got = res["matrix"][(case, profile)]
        for g, w in zip(got["full"], want["full"]):
            np.testing.assert_allclose(g, w, **REF_BAND)
        for key in ("loss", "v_norm"):
            np.testing.assert_allclose(got["metrics"][0][key], want["metrics"][0][key],
                                       rtol=REF_BAND["rtol"])


def _codec_and_shapes(case: str):
    """A byte case's codec (None: raw) and the whole leaves' per-node
    shapes."""
    from repro_torch.compression import make_compressor
    from repro_torch.models import Model, ModelConfig
    from repro_torch.tree import tree_leaves

    kw = BYTE_CASES[case]
    shapes = [tuple(s.shape) for s in tree_leaves(Model(ModelConfig(**CFG)).param_shapes())]
    comp = make_compressor(kw["compression"]) if "compression" in kw else None
    return comp, shapes


@pytest.mark.parametrize("case", sorted(BYTE_CASES))
def test_node_link_bytes_are_the_documented_count(runs, case):
    """Summed over the ranks, a round's node-link bytes at model 2 are the
    model-1 job's plus (M - 1) x R a message, R = the replicated leaves'
    payload bytes plus QSGD's 4 B scale a sharded leaf; the model group's
    payload bytes are the shared chunks."""
    comp, shapes = _codec_and_shapes(case)
    dims = runs["group"][0]["bytes"][case]["shard_dims"]
    m1 = runs["one"]["bytes"][case]["bytes"]
    m2 = [res["bytes"][case]["bytes"] for res in runs["group"]]
    f32 = torch.float32

    def payload(shape):
        return (math.prod(shape) * 4 if comp is None or comp.is_identity
                else comp.payload_bytes(shape, f32))

    whole = sum(payload(s) for s in shapes)
    extra = sum(payload(s) for s, d in zip(shapes, dims) if d is None)
    if case == "qsgd":
        extra += 4 * sum(d is not None for d in dims)
    for op in ("roll", "all_gather"):
        one = m1[op]["node_link"]
        assert one % whole == 0, (op, one, whole)
        messages = one // whole
        got = sum(b[op]["node_link"] for b in m2)
        assert got == one + messages * (MODEL - 1) * extra, (op, got, one, messages, extra)
    shared = sum(b["model"]["payload"] for b in m2)
    if case in ("top_k", "choco"):
        assert shared > 0
    else:
        assert shared == 0


@pytest.mark.parametrize("case", sorted(STATE_CASES))
def test_whole_state_is_the_model_one_state_in_the_reference_format(runs, case):
    """``TrainJob.full_state`` at model 2 (the channel's wire too: residuals,
    replicas, in-flight payloads, ages and send masks) is written in the
    reference's format and reads back into the model-1 job's state
    (``load_checkpoint(like=...)``): every leaf of its shape and dtype,
    within the band of model 1's (fp32 activations), ages and send masks
    the same; the in-flight payloads' entries but for near-ties at the
    top-k cut and flipped QSGD levels, where the two layouts' fp32
    gradients round apart (``FLY_SHARE`` of each payload tensor)."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths

    want = runs["one"]["states"][case]
    got, _ = load_checkpoint(str(runs["states"] / case), like=want, device="cpu")
    pairs = list(zip(_flatten_with_paths(got), _flatten_with_paths(want)))
    assert len(pairs) == len(_flatten_with_paths(want)) and any(
        ".comp" in p for (p, _), _ in pairs)
    for (path, g), (wpath, w) in pairs:
        assert path == wpath
        if not isinstance(w, torch.Tensor):
            assert g == w, path
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, path
        same = (np.isclose(g.numpy(), w.numpy(), **REF_BAND) if w.is_floating_point()
                else g.numpy() == w.numpy())
        if "['fly']" in path:
            assert same.mean() >= FLY_SHARE, (path, same.mean())
        else:
            assert same.all(), (path, float((g.double() - w.double()).abs().max()))


def test_top_k_moves_four_times_fewer_bytes(runs):
    """top_k 0.03125 moves at least 4x fewer node-link bytes a round than
    the uncompressed roll, at model 2 (the reference's criterion)."""
    def total(case):
        return sum(res["bytes"][case]["bytes"]["roll"]["node_link"] for res in runs["group"])

    assert 4 * total("top_k") <= total("plain"), (total("top_k"), total("plain"))


if __name__ == "__main__":
    _rank_main()
