"""Codecs, gossip channels and scenarios under the '2d' profile: a node
spread over D data x M model gloo ranks (``make_train_job(profile="2d")`` on
``NodeMesh(data=D, model=M)``), against the whole leaf's codec, the
reference's '2d' job and the model-1 job.

  * Codec level, on a 4-rank group (one node of data 2 x model 2): qsgd
    (with and without ``scale``), top_k 0.1 (on values with exact ties, and
    ratio 1.0), rand_k 0.1, low_rank 2 and error feedback, on leaves split
    over the data group on dim 0 and the model group on dim 2 (an expert,
    (4, 6, 8)), over the model group on dim 0 and the data group on dim 1
    (an embedding), over the data group on one column dim and the model
    group on another, over the data group only, over the model group only,
    and replicated: the payload gathered over the node's ranks, the decoded
    block and the residual equal the whole leaf's bit for bit (low-rank
    within 1e-6 of the leaf's max); a group that does not split a leaf
    moves nothing of it.
  * Against the reference: one subprocess runs the reference's
    ``make_train_job(..., profile=PROFILES["2d"])`` on 8 fake CPU devices,
    ``make_test_mesh((2, 2, 2), ("pod", "data", "model"))`` (2 nodes), one
    round of DSE-MVR tau 2 from each config's init plus 0.05 N(0, 1), fp32
    activations, its jnp update path (not ``--use-fused``: ROADMAP queue 3's
    closed XLA deadlock), its channel key ``jax.random.key(1)``, and writes
    the codec seeds, rand-k's index draws and low-rank's sketches its key
    chain gives.  An 8-rank group replays each case with them injected
    within rtol 5e-3 / atol 1e-4 (the QSGD cases but for one-level flips on
    at most ``FLIP_BUDGET`` of a leaf's elements): on reduced Arctic 480B
    sync qsgd on the roll, CHOCO top_k 0.25 on the neighbour wire, async:3
    qsgd with overlap, CHOCO top_k 0.25 under ``dropout_ring`` on the
    allgather wire, sync low_rank 2 and sync rand_k 0.25; on reduced
    Command R+ 104B (its tied embedding) sync qsgd.
  * Bit for bit under '2d' on 2 pods x data 2 x model 2 (a one-layer MoE,
    ``CFG``): ``compression="identity"``, ``channel="sync"`` and
    ``channel="async:1"`` give the plain '2d' job's bits for all 8
    ``ALGORITHMS``; the ``baseline`` scenario the static step's.
  * Every case of ``test_torch_layout_codecs.py``'s ``MATRIX`` (each codec,
    channel, wire and scenario) runs under '2d' there: in fp32 activations
    within the band of the same 2 nodes at model 1 (this process); the
    loss, the send decisions and the streams the same on every rank; a leaf
    replicated over a group the same bits on that group's ranks.
  * ``TrainJob.full_state`` gathers the wire state over both groups, read
    back into the model-1 job's state within the band (in-flight payloads
    as ``FLY_SHARE`` says).
  * Bytes, to the byte, for plain, qsgd, top_k and choco: a round's
    node-link bytes summed over the ranks are the model-1 job's plus the
    duplicates of every block more than one rank of a node holds
    (``compression/gossip.py``); the model and data groups' ``codec`` bytes
    are the codecs' scales and candidates, and their ``payload`` bytes the
    shared tensors' chunks, (M - 1) and M (D - 1) times them a message.
  * The CLI: ``repro_torch.launch.train`` on the 8 ranks with reduced
    Command R+ and ``--compression qsgd`` for one round is one node of
    data 4 x model 2, and its checkpointed parameters are
    ``make_train_job``'s same run's, bit for bit.

Each group initializes from a ``FileStore`` under the test's temporary
directory (``test_torch_layout_group.py``'s spawn); every process and the
whole group have deadlines of their own, so a hung gloo call fails its
test.  Ranks run one torch thread each.
"""
import argparse
import datetime
import math
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _reference_env import reference_env  # noqa: E402
from test_torch_layout_codecs import (  # noqa: E402
    ALGORITHM_NAMES, BYTE_CASES, FLIP_BUDGET, FLY_SHARE, MATRIX, PASSTHROUGH, REF_BAND,
    STATE_CASES, ReferenceDraws, _kwargs, _nest,
)
from test_torch_layout_group import (  # noqa: E402
    PROCESS_DEADLINE, _numpy, _spawn_group, fp32_activations,
)

PODS, DATA, MODEL = 2, 2, 2
WORLD = PODS * DATA * MODEL
TAU, S, B = 2, 16, 4
# a one-layer MoE: experts over 'data' and their hidden units over 'model',
# the embedding's vocabulary over 'model' and its width over 'data'
CFG = dict(name="moe-tiny", arch_type="moe", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2,
           d_ff=64, vocab_size=256, block_unit=("moe",), n_experts=4, top_k=2, moe_d_ff=64,
           dense_residual=True, capacity_factor=8.0)
HYPER = dict(tau=TAU, lr=1e-2, alpha=0.1)
# reference case -> (arch, make_train_job keywords, scenario preset or None)
REF_CASES = {
    "sync_qsgd": ("arctic_480b", dict(compression="qsgd"), None),
    "choco_top_k": ("arctic_480b", dict(channel="choco", compression="top_k:0.25",
                                        wire_mode="neighbor"), None),
    "async_overlap": ("arctic_480b", dict(channel="async:3", compression="qsgd", overlap=True),
                      None),
    "dropout_allgather": ("arctic_480b", dict(channel="choco", compression="top_k:0.25",
                                              wire_mode="allgather"), "dropout_ring"),
    "low_rank": ("arctic_480b", dict(compression="low_rank:2"), None),
    "rand_k": ("arctic_480b", dict(compression="rand_k:0.25"), None),
    "command_r_qsgd": ("command_r_plus_104b", dict(compression="qsgd"), None),
}
# the CLI's run: reduced Command R+ on the 8 ranks, one node of data 4 x model 2
CLI = ["--device", "cpu", "--arch", "command_r_plus_104b", "--reduced", "--steps", "1",
       "--tau", "2", "--seq-len", "16", "--global-batch", "4", "--compression", "qsgd",
       "--ckpt-every", "1"]
REFERENCE_DEADLINE = 300   # s, the reference's subprocess


# ------------------------------------------------------------ the rank side
def _batches(seed: int, rounds: int = 1, tau: int = TAU):
    rng = np.random.default_rng(seed)
    shape = (rounds, tau, PODS, B, S)
    return {"tokens": rng.integers(0, CFG["vocab_size"], shape),
            "targets": rng.integers(0, CFG["vocab_size"], shape)}


def run_job(mesh, kw, scenario=None, rounds=1, cfg=None, params=None, batches=None,
            fp32=False, seed_fn=None, state_out=None):
    """``rounds`` rounds of ``cfg`` (``CFG``) under '2d' on ``mesh``: after
    the last, the whole parameters, this rank's shards, each round's
    metrics, the last round's bytes, the layout and the channel's last send
    masks.  ``state_out``: a directory where global rank 0 saves the whole
    state (``TrainJob.full_state``), or a list the final state is appended
    to."""
    import torch.distributed as dist

    from repro_torch.launch.distributed import make_train_job
    from repro_torch.models import ModelConfig
    from repro_torch.scenarios import make_scenario

    if fp32:
        with fp32_activations():
            return run_job(mesh, kw, scenario, rounds, cfg, params, batches,
                           seed_fn=seed_fn, state_out=state_out)
    scen = None if scenario is None else make_scenario(scenario, seed=0)
    job = make_train_job(ModelConfig(**CFG) if cfg is None else cfg, mesh, profile="2d",
                         scenario=scen, comm_seed_fn=seed_fn, **HYPER, **_kwargs(kw))
    state = job.init_state(0, params=params)
    batches = _batches(1, rounds, job.round_len) if batches is None else batches
    sched = job.schedule_for(rounds) if scen is not None else None
    out = {"metrics": [], "shard_dims": job.shard_dims, "data_dims": job.data_dims,
           "buffers": len(job.algorithm.comm.buffers)}
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
        if dist.is_initialized() and dist.get_rank() == 0:
            save_checkpoint(str(state_out), rounds, whole)
    comp = getattr(state, "comp", None)
    out["sent"] = ([w["sent"].cpu().numpy() for w in comp.wire
                    if isinstance(w, dict) and "sent" in w] if comp is not None else [])
    return out


def _block(x, dims, groups, lead=1):
    """This rank's block of ``x``: along each (leaf) dim its group's part."""
    for d, g in zip(dims, groups):
        if d is not None:
            n = x.shape[d + lead] // g.size
            x = x.narrow(d + lead, g.index * n, n)
    return x.contiguous()


# leaf kind -> (whole per-node shape, model dim, data dim)
LEAVES = {"expert": ((4, 6, 8), 2, 0), "embedding": ((8, 6), 0, 1),
          "columns": ((4, 6, 8), 2, 1), "data": ((6, 8), None, 0),
          "model": ((6, 8), 1, None), "rep": ((6, 5), None, None)}
CODECS = ("qsgd", "qsgd_scale", "top_k", "top_k_ties", "top_k_all", "top_k_scale", "rand_k",
          "low_rank")


def codec_level(mesh) -> dict:
    """Each codec on each leaf kind: the encode of this rank's block
    against the whole leaf's (module docstring), and the bytes each group
    moved for it."""
    from repro_torch.compression.base import AtShard, ErrorFeedback, Shard
    from repro_torch.compression.compressors import LowRank, QSGD, RandK, TopK

    mg, dg, node = mesh.model_group, mesh.data_group, mesh.node_group
    codecs = {"qsgd": (QSGD(), None), "qsgd_scale": (QSGD(), 0.5),
              "top_k": (TopK(0.1), None), "top_k_ties": (TopK(0.1), None),
              "top_k_all": (TopK(1.0), None), "top_k_scale": (TopK(0.1), 0.5),
              "rand_k": (RandK(0.1), None), "low_rank": (LowRank(2), None)}

    def shard_of(whole, d, dd):
        if d is None and dd is None:
            return None
        if dd is None:
            return Shard(mg, d, whole)
        if d is None:
            return Shard(dg, dd, whole)
        return Shard(node, d, whole, data_dim=dd)

    out, n = {}, 3
    for ci, (cname, (codec, scale)) in enumerate(codecs.items()):
        for li, (lname, (whole, d, dd)) in enumerate(LEAVES.items()):
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
            before = mesh.byte_counts()
            sh = shard_of(whole, d, dd)
            if sh is None:
                ps = codec_w.encode(xw, seed, scale=scale)
                ds, whole_p = codec_w.decode(ps), ps
            else:
                bound = AtShard(inner=codec_w, shard=sh, node=node)
                ps = bound.encode(_block(xw, (d, dd), (mg, dg)), seed, scale=scale)
                ds, whole_p = bound.decode(ps), bound.whole(ps)
            after = mesh.byte_counts()
            moved = {g: sum(after[g][k] - before[g][k] for k in before[g])
                     for g in ("model", "data")}
            want_d = _block(dw, (d, dd), (mg, dg))
            res = {"moved": moved, "decoded": bool(torch.equal(ds, want_d)),
                   "decoded_bits": bool(torch.equal(ds.contiguous().view(torch.int32),
                                                    want_d.view(torch.int32)))}
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
    # error feedback: the residual of the block is the whole leaf's block
    for cname, codec in (("ef_qsgd", QSGD()), ("ef_top_k", TopK(0.1)),
                         ("ef_low_rank", LowRank(2))):
        ef = ErrorFeedback(inner=codec)
        rng = np.random.default_rng(7)
        names = [k for k in LEAVES if k != "rep"] + ["rep"]
        tree = {k: torch.from_numpy(rng.standard_normal((n,) + LEAVES[k][0]).astype(np.float32))
                for k in names}
        resid = {k: torch.from_numpy(0.1 * rng.standard_normal(v.shape).astype(np.float32))
                 for k, v in tree.items()}
        seeds = lambda leaf: 77 + leaf  # noqa: E731
        _, dec_w, res_w = ef.roundtrip(tree, resid, seeds)
        keys = sorted(tree)   # the tree's leaf order
        bound = ef.at_shards([shard_of(*LEAVES[k]) for k in keys], node)
        blocks = {k: _block(v, LEAVES[k][1:], (mg, dg)) for k, v in tree.items()}
        rblocks = {k: _block(v, LEAVES[k][1:], (mg, dg)) for k, v in resid.items()}
        _, dec_s, res_s = bound.roundtrip(blocks, rblocks, seeds)
        gap = {}
        for k in keys:
            want_dec = _block(dec_w[k], LEAVES[k][1:], (mg, dg))
            want_res = _block(res_w[k], LEAVES[k][1:], (mg, dg))
            if cname == "ef_low_rank":
                scale = float(tree[k].abs().max())
                gap[k] = max(float((dec_s[k] - want_dec).abs().max()),
                             float((res_s[k] - want_res).abs().max())) / scale
            else:
                gap[k] = bool(torch.equal(dec_s[k], want_dec) and torch.equal(res_s[k], want_res))
        out[(cname, "residual")] = gap
    return out


def passthrough_runs(mesh) -> dict:
    """One step of every algorithm, plain and with each pass-through
    channel: the final blocks' bits."""
    from repro_torch.launch.distributed import make_train_job
    from repro_torch.models import ModelConfig

    out = {}
    rng = np.random.default_rng(2)
    for name in ALGORITHM_NAMES:
        batches = None
        for tag, kw in (("plain", {}),) + tuple(PASSTHROUGH.items()):
            job = make_train_job(ModelConfig(**CFG), mesh, algorithm=name, profile="2d",
                                 **HYPER, **kw)
            if batches is None:
                shape = (job.round_len, PODS, B, S)
                batches = {"tokens": rng.integers(0, CFG["vocab_size"], shape),
                           "targets": rng.integers(0, CFG["vocab_size"], shape)}
            state, m = job.step_fn(job.init_state(0), job.local_batch(batches))
            out[(name, tag)] = {"local": _numpy(state.params),
                                "metrics": {k: float(v) for k, v in m.items()}}
    return out


def scenario_against_plain(mesh) -> dict:
    """The ``baseline`` scenario against the static job, QSGD and CHOCO."""
    out = {}
    for tag, kw in (("qsgd", dict(compression="qsgd")),
                    ("choco", dict(channel="choco", compression="top_k:0.25"))):
        out[tag] = {"static": run_job(mesh, kw, rounds=2),
                    "baseline": run_job(mesh, kw, scenario="baseline", rounds=2)}
    return out


class _Prefixed:
    """The entries of an npz under ``prefix/``, as an npz reads."""

    def __init__(self, npz, prefix: str):
        self.npz, self.prefix = npz, prefix + "/"

    @property
    def files(self):
        return [k[len(self.prefix):] for k in self.npz.files if k.startswith(self.prefix)]

    def __getitem__(self, key):
        return self.npz[self.prefix + key]


def reference_replays(mesh, npz) -> dict:
    """Each reference case replayed from its parameters, batches and
    draws, fp32 activations."""
    from repro_torch.compression import make_compressor
    from repro_torch.compression.compressors import LowRank, RandK
    from repro_torch.configs import get_reduced
    from repro_torch.convert import params_from_numpy

    out = {}
    for case, (arch, kw, scen) in REF_CASES.items():
        view = _Prefixed(npz, arch)
        draws = ReferenceDraws(view)
        batches = {k: view["batch/" + k].astype(np.int64)[None] for k in ("tokens", "targets")}
        init = params_from_numpy(_nest(npz, arch + "/init"), "cpu")
        kw = dict(kw)
        comp = kw.get("compression", "")
        if comp.startswith("rand_k"):
            kw["compression"] = make_compressor(RandK(0.25, index_draw=draws.index_draw),
                                                error_feedback=True)
        elif comp.startswith("low_rank"):
            kw["compression"] = make_compressor(LowRank(2, sketch_draw=draws.sketch_draw),
                                                error_feedback=True)
        out[case] = run_job(mesh, kw, scenario=scen, cfg=get_reduced(arch), params=init,
                            batches=batches, seed_fn=draws.seed_fn, fp32=True)
    return out


def cli_run(out_dir: Path) -> dict:
    """The CLI's run (``CLI``) on this group, then ``make_train_job``'s same
    run: its mesh line, and whether its checkpoint after round 1 is the
    job's whole parameters, bit for bit."""
    import contextlib
    import io

    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs import get_reduced
    from repro_torch.data import TokenPipeline, make_lm_tokens
    from repro_torch.launch import train
    from repro_torch.launch.distributed import make_train_job
    from repro_torch.launch.mesh import make_group_mesh
    from repro_torch.tree import tree_leaves

    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        history = train.main(CLI + ["--out", str(out_dir)])
    cfg = get_reduced("command_r_plus_104b")
    mesh = make_group_mesh(1, device="cpu", model=2, data=4)
    job = make_train_job(cfg, mesh, algorithm="dse_mvr", tau=2, lr=0.1, alpha=0.05,
                         compression="qsgd")
    pipe = TokenPipeline(make_lm_tokens(200_000, cfg.vocab_size, seed=0), 16, 4, seed=0)
    xs, ys = zip(*(pipe.batch() for _ in range(job.round_len)))
    state, m = job.step_fn(job.init_state(0), job.local_batch(
        {"tokens": np.stack([x.reshape(1, 4, 16) for x in xs]),
         "targets": np.stack([y.reshape(1, 4, 16) for y in ys])}))
    want = [t.numpy() for t in tree_leaves(job.full(state.params))]
    got = [t.numpy() for t in tree_leaves(load_checkpoint(str(out_dir / "ckpt"), 1,
                                                          device="cpu")[0])]
    return {"stdout": said.getvalue(), "loss": (history[0]["loss"], float(m["loss"])),
            "same": len(got) == len(want) and all(
                g.shape == w.shape and np.array_equal(g, w)
                for g, w in zip(got, want)),
            "mesh": (mesh.data, mesh.model, mesh.world)}


def main_group(mesh, ref_npz, tmp: Path) -> dict:
    states = tmp / "states"
    for case, kw in STATE_CASES.items():
        run_job(mesh, kw, rounds=2, fp32=True, state_out=states / case)
    return {"reference": reference_replays(mesh, np.load(ref_npz)),
            "passthrough": passthrough_runs(mesh),
            "matrix": {case: run_job(mesh, kw, scenario=scen, fp32=True)
                       for case, (kw, scen) in MATRIX.items()},
            "bytes": {case: run_job(mesh, kw) for case, kw in BYTE_CASES.items()},
            "scenario": scenario_against_plain(mesh),
            "cli": cli_run(tmp / "cli")}


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
        mesh = make_group_mesh(args.world // (DATA * MODEL), device="cpu", model=MODEL,
                               data=DATA)
        res = (main_group(mesh, args.ref, Path(args.ref).parent) if args.ref
               else {"codec": codec_level(mesh)})
        res["mesh"] = {"pod": mesh.rank, "data": mesh.data_group.index,
                       "model": mesh.model_group.index}
        torch.save(res, args.out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------- the parent side
REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.compression.base import attach_channel_state
from repro.configs import get_reduced
from repro.launch.distributed import make_train_job
from repro.launch.mesh import make_test_mesh
from repro.launch.sharding import PROFILES
from repro.models import Model
from repro.scenarios import make_scenario

# fp32 activations, as the port's replay runs them: in bf16 the packages'
# roundings differ, and a QSGD level or a top-k pick at its cut may flip
loss = Model.loss
Model.loss = lambda self, p, b, dtype=None: loss(self, p, b, jnp.float32)
mesh = make_test_mesh(({pods}, {data}, {model}), ("pod", "data", "model"))
rng = np.random.default_rng(0)
chan_key = jax.random.key(1)
res, inits = {{}}, {{}}
for case, (arch, kw, scen) in {cases}.items():
    cfg = get_reduced(arch)
    scenario = None if scen is None else make_scenario(scen, seed=0)
    job = make_train_job(cfg, mesh, gossip="roll", profile=PROFILES["2d"], scenario=scenario,
                         **{hyper}, **kw)
    if arch not in inits:
        p0 = jax.tree.map(lambda x: np.asarray(x) + np.float32(0.05) * rng.standard_normal(
            x.shape).astype(np.float32), Model(cfg).init(jax.random.key(0)))
        batch = {{k: rng.integers(0, cfg.vocab_size, ({tau}, {pods}, {b}, {s})).astype(np.int32)
                 for k in ("tokens", "targets")}}
        inits[arch] = (p0, batch)
        for k, v in jax.tree_util.tree_flatten_with_path(p0)[0]:
            res[arch + "/init/" + jax.tree_util.keystr(k)] = v
        for k, v in batch.items():
            res[arch + "/batch/" + k] = v
        # the key chain of event 0: split, fold in the buffer, fold in the leaf
        use, _ = jax.random.split(chan_key)
        shapes = [x.shape for x in jax.tree.leaves(p0)]
        seeds = np.zeros((2, len(shapes)), np.uint32)
        for bi in range(2):
            kb = jax.random.fold_in(use, bi)
            for leaf, shp in enumerate(shapes):
                key = jax.random.fold_in(kb, leaf)
                d = np.asarray(jax.random.key_data(key)).astype(np.uint32).reshape(-1)
                seed = int(d[0] ^ d[-1])
                seeds[bi, leaf] = seed
                n = int(np.prod(shp))
                k = max(1, min(n, int(np.ceil(0.25 * n))))
                res[arch + "/index/%d" % seed] = np.asarray(
                    jax.random.choice(key, n, shape=(k,), replace=False))
                if len(shp) >= 2:
                    nn = int(np.prod(shp[1:]))
                    r = min(2, shp[0], nn)
                    if r >= 1 and (shp[0] + nn) * r < shp[0] * nn:
                        res[arch + "/sketch/%d" % seed] = np.asarray(
                            jax.random.normal(key, (nn, r), jnp.float32))
        res[arch + "/seeds"] = seeds
    p0, batch = inits[arch]
    stacked = jax.tree.map(lambda p: jnp.broadcast_to(jnp.asarray(p)[None],
                                                      ({pods},) + p.shape), p0)
    state = jax.device_put(
        attach_channel_state(job.algorithm, job.algorithm.init(stacked), chan_key),
        job.state_shardings)
    batches = jax.device_put({{k: jnp.asarray(v) for k, v in batch.items()}},
                             job.batch_shardings)
    if scenario is None:
        state, m = jax.jit(job.step_fn)(state, batches)
    else:
        state, m = jax.jit(job.step_fn)(state, batches, job.round_ctx(job.schedule_for(1), 0))
    for k, v in jax.tree_util.tree_flatten_with_path(state.params)[0]:
        res[case + "/" + jax.tree_util.keystr(k)] = np.asarray(v)
    res[case + "_loss"] = np.asarray(m["loss"])
np.savez(sys.argv[1], **res)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's jobs (a subprocess) beside the 4-rank group and the
    model-1 runs in this process, then the 8-rank group."""
    from repro_torch.launch.mesh import make_test_mesh

    tmp = tmp_path_factory.mktemp("layout_2d_codecs")
    ref_npz = tmp / "reference.npz"
    code = textwrap.dedent(REFERENCE.format(
        pods=PODS, data=DATA, model=MODEL, tau=TAU, b=B, s=S, hyper=HYPER, cases=REF_CASES))
    ref = subprocess.Popen([sys.executable, "-c", code, str(ref_npz)],
                           env=reference_env(REFERENCE_DEADLINE, devices=WORLD),
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        node = _spawn_group(DATA * MODEL, tmp, script=__file__)
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            mesh = make_test_mesh(PODS, device="cpu")
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
        log = ref.communicate(timeout=REFERENCE_DEADLINE)[0]
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log[-4000:]
    group = _spawn_group(WORLD, tmp, ("--ref", str(ref_npz)), script=__file__)
    return {"one": one, "group": group, "node": node, "ref": np.load(ref_npz),
            "states": tmp / "states"}


def _codec_cases():
    return [(c, leaf) for c in CODECS for leaf in LEAVES]


@pytest.mark.parametrize("codec,leaf", _codec_cases())
def test_a_blocks_encode_is_the_whole_leafs(runs, codec, leaf):
    """The payload gathered over the node's ranks and the decoded block are
    the whole leaf's, bit for bit (low-rank within 1e-6 of the leaf's max);
    a group that does not split the leaf moves nothing of it."""
    _, d, dd = LEAVES[leaf]
    for res in runs["node"]:
        got = res["codec"][(codec, leaf)]
        if codec == "low_rank":
            assert max(got["payload"].values()) < 1e-6, got
        else:
            assert got["decoded"] and got["decoded_bits"], got
            assert all(got["payload"].values()), got
        if d is None:
            assert got["moved"]["model"] == 0, got["moved"]
        if dd is None:
            assert got["moved"]["data"] == 0, got["moved"]


@pytest.mark.parametrize("codec", ["ef_qsgd", "ef_top_k", "ef_low_rank"])
def test_error_feedback_keeps_the_block_of_the_whole_residual(runs, codec):
    for res in runs["node"]:
        got = res["codec"][(codec, "residual")]
        assert set(got) == set(LEAVES)
        if codec == "ef_low_rank":
            assert max(got.values()) < 1e-6, got
        else:
            assert all(got.values()), got


@pytest.mark.parametrize("case", sorted(REF_CASES))
def test_2d_codecs_match_the_reference(runs, case):
    """The 8-rank group replays the reference's (2, 2, 2)-mesh job within
    rtol 5e-3 / atol 1e-4 (QSGD as ``FLIP_BUDGET`` says), its loss within
    rtol 1e-4, the same loss on every rank."""
    from repro_torch.tree import tree_leaves

    ref = runs["ref"]
    want = [np.asarray(x) for x in tree_leaves(_nest(ref, case))]
    qsgd = "qsgd" in REF_CASES[case][1].get("compression", "")
    for res in runs["group"]:
        got = res["reference"][case]
        assert len(got["full"]) == len(want)
        for g, w in zip(got["full"], want):
            assert g.shape == w.shape, (g.shape, w.shape)
            if not qsgd:
                np.testing.assert_allclose(g, w, **REF_BAND)
                continue
            out = ~np.isclose(g, w, **REF_BAND)
            assert out.mean() <= FLIP_BUDGET, (out.sum(), out.size)
            assert (np.abs(g - w)[out] <= 2 * np.abs(w).max() / 127).all()
        np.testing.assert_allclose(got["metrics"][0]["loss"], float(ref[case + "_loss"]),
                                   rtol=1e-4)
        _same_metrics(got, runs["group"][0]["reference"][case])


@pytest.mark.parametrize("tag", sorted(PASSTHROUGH))
@pytest.mark.parametrize("name", ALGORITHM_NAMES)
def test_passthrough_channels_are_the_plain_2d_job(runs, name, tag):
    """identity, sync and async:1 give the plain '2d' job's bits."""
    for res in runs["group"]:
        want = res["passthrough"][(name, "plain")]
        got = res["passthrough"][(name, tag)]
        for g, w in zip(got["local"], want["local"]):
            np.testing.assert_array_equal(g, w)
        assert got["metrics"] == want["metrics"]


@pytest.mark.parametrize("codec", ["qsgd", "choco"])
def test_baseline_scenario_is_the_static_2d_step(runs, codec):
    for res in runs["group"]:
        got = res["scenario"][codec]
        for g, w in zip(got["baseline"]["local"], got["static"]["local"]):
            np.testing.assert_array_equal(g, w)
        for m_b, m_s in zip(got["baseline"]["metrics"], got["static"]["metrics"]):
            assert m_b["loss"] == m_s["loss"] and m_b["v_norm"] == m_s["v_norm"]


def _same_metrics(a, b):
    """The same metrics, bit for bit (NaN streams equal)."""
    for x, y in zip(a["metrics"], b["metrics"]):
        assert sorted(x) == sorted(y)
        np.testing.assert_array_equal([x[k] for k in sorted(x)], [y[k] for k in sorted(y)])


def _ranks(group):
    """(pod, data, model) -> the rank's results."""
    return {(r["mesh"]["pod"], r["mesh"]["data"], r["mesh"]["model"]): r for r in group}


@pytest.mark.parametrize("case", sorted(MATRIX))
def test_every_wire_runs_under_2d(runs, case):
    """Each codec, channel, wire and scenario on 2 pods x data 2 x model 2:
    the same loss, streams and send masks on every rank of a pod (the loss
    and streams on all 8), a leaf replicated over a group the same bits on
    its ranks; in fp32 activations within the band of the same 2 nodes at
    model 1."""
    by = _ranks(runs["group"])
    first = runs["group"][0]["matrix"][case]
    for (p, d, m), res in by.items():
        got = res["matrix"][case]
        _same_metrics(got, first)
        for a, b in zip(got["sent"], by[p, 0, 0]["matrix"][case]["sent"]):
            np.testing.assert_array_equal(a, b)
        for i, (md, dd) in enumerate(zip(first["shard_dims"], first["data_dims"])):
            if md is None:
                np.testing.assert_array_equal(got["local"][i], by[p, d, 0]["matrix"][case]["local"][i])
            if dd is None:
                np.testing.assert_array_equal(got["local"][i], by[p, 0, m]["matrix"][case]["local"][i])
        for leaf in got["full"]:
            assert np.isfinite(leaf).all()
    both = sum(md is not None and dd is not None
               for md, dd in zip(first["shard_dims"], first["data_dims"]))
    assert both >= 3, (first["shard_dims"], first["data_dims"])
    want = runs["one"]["matrix"][case]
    for res in runs["group"]:
        got = res["matrix"][case]
        for g, w in zip(got["full"], want["full"]):
            np.testing.assert_allclose(g, w, **REF_BAND)
        for key in ("loss", "v_norm"):
            np.testing.assert_allclose(got["metrics"][0][key], want["metrics"][0][key],
                                       rtol=REF_BAND["rtol"])
        for key, val in want["metrics"][0].items():
            if key not in ("loss", "v_norm") and np.isfinite(val):
                np.testing.assert_allclose(got["metrics"][0][key], val, **REF_BAND)


def _payload_bytes(comp, shape) -> int:
    f32 = torch.float32
    return (math.prod(shape) * 4 if comp is None or comp.is_identity
            else comp.payload_bytes(shape, f32))


def _codec_and_shapes(case: str):
    from repro_torch.compression import make_compressor
    from repro_torch.models import Model, ModelConfig
    from repro_torch.tree import tree_leaves

    kw = BYTE_CASES[case]
    shapes = [tuple(s.shape) for s in tree_leaves(Model(ModelConfig(**CFG)).param_shapes())]
    comp = make_compressor(kw["compression"]) if "compression" in kw else None
    return comp, shapes


def _split(d, dd) -> int:
    """Distinct blocks of a leaf over a node's ranks."""
    return (MODEL if d is not None else 1) * (DATA if dd is not None else 1)


@pytest.mark.parametrize("case", sorted(BYTE_CASES))
def test_node_link_bytes_are_the_documented_count(runs, case):
    """Summed over the 8 ranks, a round's node-link bytes are the model-1
    job's plus, a message, the duplicates of every block more than one rank
    of a node holds: (D M / k - 1) x a tensor's bytes for a tensor in k
    blocks (a replicated leaf's payload and QSGD's scale: k = 1; a shared
    tensor none)."""
    comp, shapes = _codec_and_shapes(case)
    first = runs["group"][0]["bytes"][case]
    dims, ddims = first["shard_dims"], first["data_dims"]
    m1 = runs["one"]["bytes"][case]["bytes"]
    per_node = DATA * MODEL
    whole = sum(_payload_bytes(comp, s) for s in shapes)
    extra = 0
    for s, d, dd in zip(shapes, dims, ddims):
        k = _split(d, dd)
        if k == 1 or comp is None:
            extra += (per_node // k - 1) * _payload_bytes(comp, s)
        elif case == "qsgd":   # the levels of the block, the scale from every rank
            extra += (per_node // k - 1) * math.prod(s) + (per_node - 1) * 4
    for op in ("roll", "all_gather"):
        one = m1[op]["node_link"]
        assert one % whole == 0, (op, one, whole)
        got = sum(res["bytes"][case]["bytes"][op]["node_link"] for res in runs["group"])
        assert got == one + one // whole * extra, (op, got, one, extra)


@pytest.mark.parametrize("case", sorted(BYTE_CASES))
def test_group_bytes_are_the_documented_count(runs, case):
    """Summed over the 8 ranks, the model group's and the data group's
    ``codec`` bytes are QSGD's scale maxima (4 B a split leaf, the node's
    rows) and top-k's candidates (8 B each, ``min(k, d / blocks)`` from each
    rank, the data group's messages holding the model ranks' lists) for
    every gossiped buffer, and their ``payload`` bytes (M - 1) and M (D -
    1) times the shared tensors' bytes a message."""
    comp, shapes = _codec_and_shapes(case)
    first = runs["group"][0]["bytes"][case]
    dims, ddims, buffers = first["shard_dims"], first["data_dims"], first["buffers"]
    m1 = runs["one"]["bytes"][case]["bytes"]["roll"]["node_link"]
    messages = m1 // sum(_payload_bytes(comp, s) for s in shapes)
    want = {"model": {"codec": 0, "payload": 0}, "data": {"codec": 0, "payload": 0}}
    for s, d, dd in zip(shapes, dims, ddims):
        k = _split(d, dd)
        if k == 1 or comp is None:
            continue
        if case == "qsgd":
            per = {"model": (MODEL - 1) * 4, "data": (DATA - 1) * 4}
        else:
            cand = 8 * min(comp.inner.k_for(math.prod(s)), math.prod(s) // k)
            per = {"model": (MODEL - 1) * cand,
                   "data": (DATA - 1) * (MODEL if d is not None else 1) * cand}
            shared = _payload_bytes(comp, s)
            want["model"]["payload"] += (MODEL - 1) * shared * messages
            want["data"]["payload"] += MODEL * (DATA - 1) * shared * messages
        for g, split in (("model", d), ("data", dd)):
            if split is not None:
                want[g]["codec"] += WORLD * buffers * per[g]
    for g in ("model", "data"):
        for key in ("codec", "payload"):
            got = sum(res["bytes"][case]["bytes"][g][key] for res in runs["group"])
            assert got == want[g][key], (g, key, got, want[g][key])
    if comp is not None:
        assert want["model"]["codec"] > 0 and want["data"]["codec"] > 0
    if case in ("top_k", "choco"):
        assert want["data"]["payload"] > 0


@pytest.mark.parametrize("case", sorted(STATE_CASES))
def test_whole_2d_state_is_the_model_one_state(runs, case):
    """``TrainJob.full_state`` under '2d' (replicas, residuals, in-flight
    payloads, ages and send masks gathered over both groups) reads back into
    the model-1 job's state within the band (fp32 activations), ages and
    send masks the same, the in-flight payloads as ``FLY_SHARE`` says."""
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


def test_the_cli_compresses_a_2d_node_as_make_train_job(runs):
    """``--compression qsgd`` on reduced Command R+ over 8 ranks: one node
    of data 4 x model 2, the reference's mesh line, and the checkpointed
    parameters of ``make_train_job``'s same run, bit for bit."""
    for res in runs["group"]:
        got = res["cli"]
        assert got["mesh"] == (4, 2, 1)
        assert got["same"], got["loss"]
        assert got["loss"][0] == got["loss"][1] and np.isfinite(got["loss"][0])
    lead = runs["group"][0]["cli"]["stdout"]
    for line in ("mesh={'data': 4, 'model': 2}", "1 decentralized nodes (2d profile)"):
        assert line in lead, lead[-2000:]


if __name__ == "__main__":
    _rank_main()
