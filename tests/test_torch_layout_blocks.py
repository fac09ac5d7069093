"""Tensor parallelism ('tp') for the MoE, Mamba-2 and RWKV-6 blocks and
HuBERT's encoder: ``make_train_job(profile="tp")`` on spawned gloo groups,
against the reference's ``make_train_job`` and against the whole model.

  * Against the reference: one subprocess runs the reference's
    ``make_train_job(..., profile=PROFILES["tp"])`` on 4 fake CPU devices,
    mesh (2, 2) (2 nodes x a model axis of 2), DSE-MVR tau 3, one round,
    for the reduced Qwen1.5-MoE-A2.7B, Zamba2-7B, RWKV-6 3B and HuBERT
    X-Large, each from its init plus 0.05 N(0, 1).  A 4-rank group (2 nodes
    x model 2) replays them from the same parameters and batches within the
    reference's band between its sharded job and its single-device path,
    rtol 5e-3 / atol 1e-4 (``tests/test_distributed.py``), the loss within
    rtol 1e-4.
    Both sides run fp32 activations (``Model.loss`` wrapped; the engines
    ask for bf16): in bf16 the reference's own tp round lies up to 8.0 times
    the band from its model-1 round on these blocks (the MoE's routes flip
    between the layouts' roundings), so a bf16 comparison would measure
    rounding, not the layout.  The same round with the engine's bf16
    activations gives the byte counts and the replicated leaves below.
  * The tensor-parallel model alone on a 2-rank group against the whole
    model: in fp64 (the model's fp32 casts kept fp64, ``float64_throughout``)
    the loss and every leaf's gradient (the rank's part) within 1e-12 of
    the leaf's largest gradient: the same function (and so for three
    variants whose layout falls back: the MoE dropping entries, 3 experts
    on 2 ranks, one Mamba-2 head).  In fp32 the loss within
    1e-5 and every leaf's gradient within 1e-5 of its largest, or, where the
    whole model's own fp32 gradient is farther than a quarter of that from
    the fp64 one, within 4 times that own error (two fp32 programs, each
    off the exact gradient by about as much): Mamba-2's leaves and the
    norms before them are ill-conditioned in fp32 (on the reduced Zamba2
    the whole model's own error reaches 1.8e-5 of a leaf's largest
    gradient, the tensor-parallel model's 2.5e-5, over 8 draws of
    ``scripts/tp_numerics_probe.py grad``; in fp64 the two agree to
    1.4e-14).  Both router losses are nonzero; the MoE's
    routing (experts and the kept mask) is exactly the whole model's, with
    and without dropped entries.
  * Replicated leaves hold the same bits on both model ranks of a node; the
    model group's byte counts show each block's collectives (the MoE
    router's logits and Mamba-2's projection and conv weights gathered,
    their gradients reduce-scattered, to the byte; RWKV-6 and HuBERT
    all-reduce only).
  * The new collectives on the 2-rank group: ``ModelGroup.sum_shards``
    (all-reduce forward and backward), ``gather_from`` and ``gather_sum``,
    and ``sharded_rms_norm``'s value and gradients against the whole
    norm's.

Each group initializes from a ``FileStore`` under the test's temporary
directory; every process and the whole group have deadlines of their own,
so a hung gloo call fails its test.  Ranks run one torch thread each.
"""
import argparse
import contextlib
import dataclasses
import datetime
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _reference_env import reference_env  # noqa: E402
from test_torch_layout_group import (  # noqa: E402
    GROUP_DEADLINE, PROCESS_DEADLINE, REF_BAND, _nest, _numpy, _spawn_group, fp32_activations,
)

ARCHS = ("qwen2_moe_a2_7b", "zamba2_7b", "rwkv6_3b", "hubert_xlarge")
NODES, MODEL, TAU, B, S = 2, 2, 3, 2, 16
HYPER = dict(tau=TAU, lr=1e-2, alpha=0.1)
GRAD_TOL = 1e-5
EXACT_TOL = 1e-12          # fp64
# where the whole model's own fp32 gradient of a leaf is off its fp64 one by
# more than GRAD_TOL / NOISE, the fp32 gap is held to NOISE times that error
NOISE = 4
# the cases against the whole model: each arch, and variants whose layout
# falls back: the MoE at a capacity factor that drops entries; 3 experts,
# which do not divide by the model axis (the experts' hidden units shard and
# the router is replicated); Mamba-2 with one SSM head of 256 (the heads
# and the fused projection replicated, the block whole on every rank)
VARIANTS = {
    "qwen2_moe_drops": ("qwen2_moe_a2_7b", dict(capacity_factor=0.5)),
    "qwen2_moe_3_experts": ("qwen2_moe_a2_7b", dict(n_experts=3)),
    "zamba2_one_head": ("zamba2_7b", dict(ssm_head_dim=256)),
}
WHOLE_CASES = ARCHS + tuple(VARIANTS)
MOE_CASES = tuple(c for c in WHOLE_CASES if c.startswith("qwen2_moe"))


def _config(case: str):
    from repro_torch.configs import get_reduced

    if case in VARIANTS:
        arch, change = VARIANTS[case]
        return dataclasses.replace(get_reduced(arch), **change)
    return get_reduced(case)


# ------------------------------------------------------------ the rank side
def _local(whole, dims, index: int):
    """The model shard ``index`` of each whole leaf (None: replicated)."""
    return [w if d is None else w.narrow(d, index * (w.shape[d] // MODEL),
                                         w.shape[d] // MODEL).contiguous()
            for w, d in zip(whole, dims)]


@contextlib.contextmanager
def float64_throughout():
    """The model's fp32 casts (``.float()``, fp32 ``zeros`` / ``empty``)
    keep fp64 tensors fp64 while ``on[0]`` is set: a fp64 run is fp64 all
    the way."""
    on = [False]
    cast, zeros, empty = torch.Tensor.float, torch.zeros, torch.empty

    def widen(make):
        def made(*a, **kw):
            if on[0] and kw.get("dtype") is torch.float32:
                kw["dtype"] = torch.float64
            return make(*a, **kw)
        return made

    torch.Tensor.float = lambda t, *a, **kw: t if on[0] and t.dtype == torch.float64 \
        else cast(t, *a, **kw)
    torch.zeros, torch.empty = widen(zeros), widen(empty)
    try:
        yield on
    finally:
        torch.Tensor.float, torch.zeros, torch.empty = cast, zeros, empty


def replay(mesh, npz, arch: str, fp32: bool) -> dict:
    """The reference's round of ``arch`` from its parameters and batches
    (fp32 activations, or the engine's bf16): the whole parameters after
    it, this rank's shards, the metrics, the model group's bytes and the
    leaves' layout."""
    if fp32:
        with fp32_activations():
            return replay(mesh, npz, arch, False)
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.distributed import make_train_job

    cfg = _config(arch)
    job = make_train_job(cfg, mesh, profile="tp", **HYPER)
    init = params_from_numpy(_nest(npz, arch + "/init"), "cpu")
    batches = {k.split("/")[-1]: torch.as_tensor(npz[k]) for k in npz.files
               if k.startswith(arch + "/batch/")}
    if "frames" in batches:
        batches["frames"] = batches["frames"].to(torch.bfloat16)
    state = job.init_state(0, params=init)
    mesh.reset_bytes()
    state, m = job.step_fn(state, job.local_batch(batches))
    moved = mesh.byte_counts()
    return {"full": _numpy(job.full(state.params)), "local": _numpy(state.params),
            "metrics": {k: float(v) for k, v in m.items()}, "bytes": moved,
            "shard_dims": job.shard_dims, "round_len": job.round_len}


def tp_against_whole(mesh, case: str) -> dict:
    """The loss and gradients of the tensor-parallel model on this rank's
    shards against the whole model's on one batch, in fp32 and in fp64:
    the loss's relative gap, each leaf's largest gradient gap relative to
    its max |gradient| (fp32, fp64, and the whole model's own fp32 gap to
    its fp64 gradient), the router losses, and the MoE's routing both
    ways."""
    from repro_torch.launch.distributed import make_train_job
    from repro_torch.models.mlp import moe_routing
    from repro_torch.tree import tree_flatten, tree_unflatten

    cfg = _config(case)
    job = make_train_job(cfg, mesh, profile="tp")
    whole, treedef = tree_flatten(job.model.init(0, device="cpu"))
    rng = np.random.default_rng(5)
    whole = [w + 0.05 * torch.as_tensor(rng.standard_normal(tuple(w.shape)), dtype=w.dtype)
             for w in whole]
    shards = _local(whole, job.shard_dims, mesh.model_group.index)
    batch = {"targets": torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)))}
    if cfg.audio_frontend_dim:
        batch["frames"] = torch.as_tensor(rng.standard_normal((B, S, cfg.audio_frontend_dim)),
                                          dtype=torch.float32)
    else:
        batch["tokens"] = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)))
    got = {}
    with float64_throughout() as wide:
        for dt in (torch.float32, torch.float64):
            wide[0] = dt == torch.float64
            for tag, leaves, tp in (("whole", whole, None), ("tp", shards, mesh.model_group)):
                ps = [p.detach().to(dt).requires_grad_(True) for p in leaves]
                params = tree_unflatten(treedef, ps)
                with torch.enable_grad():
                    _, aux = job.model.forward(params, batch, dtype=dt, tp=tp)
                    loss = job.model.loss(params, batch, dtype=dt, tp=tp)
                    grads = torch.autograd.grad(loss, ps, materialize_grads=True)
                got[tag, dt] = (float(loss.detach()), grads, float(aux.detach()))

    def gaps(a, b):
        b = _local(b, job.shard_dims, mesh.model_group.index)
        return [float((x.double() - y.double()).abs().max()) / max(float(y.abs().max()), 1e-30)
                for x, y in zip(a, b)]

    f32, f64 = torch.float32, torch.float64
    out = {"loss_gap": {dt: abs(got["tp", dt][0] - got["whole", dt][0]) / abs(got["whole", dt][0])
                        for dt in (f32, f64)},
           "aux": (got["whole", f32][2], got["tp", f32][2]),
           "leaf_gaps": {dt: gaps(got["tp", dt][1], got["whole", dt][1]) for dt in (f32, f64)},
           "whole_fp32_error": gaps(_local(got["whole", f32][1], job.shard_dims,
                                           mesh.model_group.index), got["whole", f64][1]),
           "dims": tree_unflatten(treedef, list(job.shard_dims))}
    if "moe" in cfg.block_unit:
        h = torch.as_tensor(rng.standard_normal((B, S, cfg.d_model)), dtype=torch.float32)
        ffn = {tag: {k: v[0] for k, v in tree_unflatten(treedef, leaves)["blocks"]["b0"]
                     ["ffn"].items() if k != "shared"}
               for tag, leaves in (("whole", whole), ("tp", shards))}
        out["routing"] = {
            tag: [t.numpy() for t in moe_routing(cfg.moe_cfg(), ffn[tag], h, tp=tp)]
            for tag, tp in (("whole", None), ("tp", mesh.model_group))}
    return out


def collectives(group) -> dict:
    """The new collectives' values and gradients on this rank: each rank's
    input is its index plus a fixed draw, and each rank's upstream gradient
    its own draw; the whole norm against the sharded one."""
    from repro_torch.models.common import rms_norm, sharded_rms_norm

    rng = np.random.default_rng(7)
    xs = [torch.as_tensor(rng.standard_normal((3, 4)), dtype=torch.float32) + r
          for r in range(MODEL)]
    gs = [torch.as_tensor(rng.standard_normal((3, 4 * MODEL)), dtype=torch.float32)
          for _ in range(MODEL)]
    me = group.index
    out = {"xs": [x.numpy() for x in xs], "gs": [g.numpy() for g in gs]}
    for name, fn, gshape in (("sum_shards", group.sum_shards, (3, 4)),
                             ("gather_from", lambda x: group.gather_from(x, 1), None),
                             ("gather_sum", lambda x: group.gather_sum(x, 1), None)):
        x = xs[me].clone().requires_grad_(True)
        y = fn(x)
        g = gs[me][:, :4] if gshape else gs[me]
        out[name] = (y.detach().numpy(), torch.autograd.grad(y, x, g)[0].numpy())
    # the norm: rows of 4 M channels, this rank's 4, against the whole
    x = torch.as_tensor(rng.standard_normal((2, 5, 4 * MODEL)), dtype=torch.float32)
    w = torch.as_tensor(rng.standard_normal(4 * MODEL), dtype=torch.float32)
    up = torch.as_tensor(rng.standard_normal((2, 5, 4 * MODEL)), dtype=torch.float32)
    part = slice(4 * me, 4 * me + 4)
    xw = [x.clone().requires_grad_(True), w.clone().requires_grad_(True)]
    want = rms_norm(*xw)
    dwant = torch.autograd.grad(want, xw, up)
    xl = [x[..., part].clone().requires_grad_(True), w[part].clone().requires_grad_(True)]
    got = sharded_rms_norm(xl[0], xl[1], group, 4 * MODEL)
    dgot = torch.autograd.grad(got, xl, up[..., part])
    out["norm"] = {"value": float((got - want[..., part]).abs().max()),
                   "dx": float((dgot[0] - dwant[0][..., part]).abs().max()),
                   "dw": float((dgot[1] - dwant[1][part]).abs().max()),
                   "scale": float(dwant[0].abs().max())}
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
        mesh = make_group_mesh(args.world // MODEL, device="cpu", model=MODEL)
        if args.ref:
            npz = np.load(args.ref)
            res = {"fp32": {arch: replay(mesh, npz, arch, True) for arch in ARCHS},
                   "bf16": {arch: replay(mesh, npz, arch, False) for arch in ARCHS}}
        else:
            res = {"whole": {case: tp_against_whole(mesh, case) for case in WHOLE_CASES},
                   "collectives": collectives(mesh.model_group)}
        res["mesh"] = {"rank": mesh.rank, "index": mesh.model_group.index}
        torch.save(res, args.out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------- the parent side
REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_reduced
from repro.launch.distributed import make_train_job
from repro.launch.mesh import make_test_mesh
from repro.launch.sharding import PROFILES
from repro.models import Model

loss = Model.loss
Model.loss = lambda self, params, batch, dtype=None: loss(self, params, batch, jnp.float32)

mesh = make_test_mesh(({nodes}, {model}), ("data", "model"))
rng = np.random.default_rng(0)
res = {{}}
for arch in {archs}:
    cfg = get_reduced(arch)
    job = make_train_job(cfg, mesh, gossip="roll", profile=PROFILES["tp"], **{hyper})
    assert job.n_nodes == {nodes}
    shape = ({tau}, {nodes}, {b}, {s})
    batch = {{"targets": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}}
    if cfg.audio_frontend_dim:
        frames = rng.standard_normal(shape + (cfg.audio_frontend_dim,)).astype(np.float32)
        batch["frames"] = np.asarray(jnp.asarray(frames, jnp.bfloat16).astype(jnp.float32))
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    p0 = jax.tree.map(lambda x: np.asarray(x) + np.float32(0.05) * rng.standard_normal(
        x.shape).astype(np.float32), job.model.init(jax.random.key(0)))
    for k, v in jax.tree_util.tree_flatten_with_path(p0)[0]:
        res[arch + "/init/" + jax.tree_util.keystr(k)] = v
    for k, v in batch.items():
        res[arch + "/batch/" + k] = v
    stacked = jax.tree.map(lambda p: jnp.broadcast_to(jnp.asarray(p)[None], ({nodes},) + p.shape),
                           p0)
    state = job.algorithm.init(stacked)
    step = jax.jit(job.step_fn, in_shardings=(job.state_shardings, job.batch_shardings),
                   out_shardings=(job.state_shardings, None))
    feed = {{k: jnp.asarray(v, jnp.bfloat16 if k == "frames" else None)
             for k, v in batch.items()}}
    state, m = step(state, feed)
    for k, v in jax.tree_util.tree_flatten_with_path(state.params)[0]:
        res[arch + "/params/" + jax.tree_util.keystr(k)] = np.asarray(v)
    res[arch + "/loss"] = np.asarray(m["loss"])
np.savez(sys.argv[1], **res)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's jobs (a subprocess, beside the 2-rank group), then
    the 4-rank group's replay, run once for the module."""
    tmp = tmp_path_factory.mktemp("layout_blocks")
    ref_npz = tmp / "reference.npz"
    env = reference_env(GROUP_DEADLINE, devices=NODES * MODEL)
    code = textwrap.dedent(REFERENCE.format(nodes=NODES, model=MODEL, tau=TAU, b=B, s=S,
                                            archs=ARCHS, hyper=HYPER))
    ref = subprocess.Popen([sys.executable, "-c", code, str(ref_npz)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        pair = _spawn_group(MODEL, tmp, script=__file__)
        log = ref.communicate(timeout=GROUP_DEADLINE)[0]
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log[-4000:]
    group = _spawn_group(NODES * MODEL, tmp, ("--ref", str(ref_npz)), script=__file__)
    return {"group": group, "pair": pair, "ref": np.load(ref_npz)}


@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_match_the_reference(runs, arch):
    """The 4-rank group replays the reference's (2, 2)-mesh tp job (fp32
    activations on both sides) within rtol 5e-3 / atol 1e-4, its loss
    within rtol 1e-4."""
    from repro_torch.tree import tree_leaves

    ref = runs["ref"]
    want = [np.asarray(x) for x in tree_leaves(_nest(ref, arch + "/params"))]
    for res in runs["group"]:
        got = res["fp32"][arch]
        assert got["round_len"] == TAU and len(got["full"]) == len(want)
        for g, w in zip(got["full"], want):
            np.testing.assert_allclose(g, w, **REF_BAND)
        np.testing.assert_allclose(got["metrics"]["loss"], float(ref[arch + "/loss"]),
                                   rtol=1e-4)


@pytest.mark.parametrize("case", WHOLE_CASES)
def test_tensor_parallel_blocks_are_the_whole_model_in_fp64(runs, case):
    """In fp64 the tensor-parallel loss and each rank's gradients equal the
    whole model's within 1e-12 (relative to each leaf's largest)."""
    for res in runs["pair"]:
        got = res["whole"][case]
        assert got["loss_gap"][torch.float64] < EXACT_TOL, got["loss_gap"]
        worst = max(got["leaf_gaps"][torch.float64])
        assert worst < EXACT_TOL, (case, worst)


@pytest.mark.parametrize("case", WHOLE_CASES)
def test_tensor_parallel_blocks_are_the_whole_model_in_fp32(runs, case):
    """In fp32 the tensor-parallel loss and each rank's gradients equal the
    whole model's within 1e-5 (relative to each leaf's largest), or within 4
    times the whole model's own fp32 error on a leaf where that error
    exceeds 2.5e-6; a MoE's router losses are nonzero and the same."""
    for res in runs["pair"]:
        got = res["whole"][case]
        assert got["loss_gap"][torch.float32] < GRAD_TOL, got["loss_gap"]
        over = [(i, gap, own) for i, (gap, own) in enumerate(
            zip(got["leaf_gaps"][torch.float32], got["whole_fp32_error"]))
            if gap >= max(GRAD_TOL, NOISE * own)]
        assert not over, (case, over)
        whole, tp = got["aux"]
        if "moe" in case:
            assert whole > 0 and abs(tp - whole) <= GRAD_TOL * whole, got["aux"]
        else:
            assert whole == tp == 0


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_routing_is_the_whole_models(runs, case):
    """Every rank routes every token as the whole model does: the same
    experts and the same kept mask, exactly (at the reduced config's
    capacity factor of 8 nothing drops; at 0.5 some entries do)."""
    for res in runs["pair"]:
        (we, wk), (ge, gk) = (res["whole"][case]["routing"][t] for t in ("whole", "tp"))
        np.testing.assert_array_equal(ge, we)
        np.testing.assert_array_equal(gk, wk)
        assert wk.all() == (case != "qwen2_moe_drops")


@pytest.mark.parametrize("case", ("qwen2_moe_3_experts", "zamba2_one_head"))
def test_variants_lay_out_as_they_fall_back(runs, case):
    """The variants take the fallback layouts the whole-model tests hold:
    3 experts keep the router whole and shard the experts' hidden units;
    one SSM head keeps the heads and the fused projection whole."""
    block = runs["pair"][0]["whole"][case]["dims"]["blocks"]["b0"]
    if case == "qwen2_moe_3_experts":   # (layers, experts, ...) leaves
        assert block["ffn"]["router"] is None
        assert (block["ffn"]["w_gate"], block["ffn"]["w_down"]) == (3, 2)
    else:
        assert block["mamba"]["a_log"] is None and block["mamba"]["w_in"] is None
        assert block["mamba"]["conv_w"] == 2 and block["mamba"]["w_out"] == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_shards_and_replicated_leaves(runs, arch):
    """Each rank holds its part of every sharded leaf of the gathered
    parameters; a replicated leaf holds the same bits on both model ranks
    of a node."""
    group = runs["group"]
    dims = group[0]["bf16"][arch]["shard_dims"]
    assert any(d is not None for d in dims) and any(d is None for d in dims)
    for r_i, res in enumerate(group):
        m, node = r_i % MODEL, r_i // MODEL
        for act in ("bf16", "fp32"):
            got = res[act][arch]
            _check_shards(got, group[r_i - m][act][arch], dims, m, node)


def _check_shards(got, first, dims, m: int, node: int) -> None:
    """A rank's shards against the gathered parameters, and its replicated
    leaves against those of its node's first model rank (``first``)."""
    for leaf, (full, local, d) in enumerate(zip(got["full"], got["local"], dims)):
        rows = full[node:node + 1]
        if d is None:
            np.testing.assert_array_equal(local, first["local"][leaf])
            np.testing.assert_array_equal(local, rows)
        else:
            n = full.shape[d + 1] // MODEL
            np.testing.assert_array_equal(
                local, np.take(rows, range(m * n, (m + 1) * n), axis=d + 1))


def _gathered_bytes(arch: str):
    """The model group's all-gather and reduce-scatter bytes a rank receives
    in one round of ``arch``: the MoE router's fp32 logits (each peer's
    experts' columns) a MoE layer; Mamba-2's bf16 projection columns and
    fp32 conv weights a Mamba-2 layer, their fp32 gradients back."""
    cfg = _config(arch)
    fwd = 2 * (TAU - 1) + 1                      # a node's forwards a round
    tok = B * S
    peers = MODEL - 1
    if "moe" in cfg.block_unit:
        gather = cfg.n_layers * tok * (cfg.n_experts // MODEL) * 4
        return fwd * peers * gather, 0
    n_mamba = cfg.block_unit.count("mamba") * cfg.repeats
    mcfg = cfg.mamba_cfg()
    di, n, h = mcfg.d_inner, mcfg.state_dim, mcfg.n_heads
    cols, conv = (2 * di + 2 * n + h) // MODEL, (di + 2 * n) // MODEL * mcfg.conv_width
    return (fwd * peers * n_mamba * (tok * cols * 2 + conv * 4),
            fwd * peers * n_mamba * (tok * cols * 4 + conv * 4))


@pytest.mark.parametrize("arch", ARCHS)
def test_block_collectives(runs, arch):
    """The model group moves what each block needs: every arch all-reduces
    (partial outputs, norms' statistics, input gradients); the MoE gathers
    its router's logits, Mamba-2 its projection and conv weights (their
    gradients reduce-scattered), to the byte; RWKV-6 and HuBERT gather
    nothing."""
    gather, scatter = _gathered_bytes(arch)
    for res in runs["group"]:
        moved = res["bf16"][arch]["bytes"]
        assert moved["model"]["all_reduce"] > 0 and moved["roll"]["process"] > 0
        assert moved["model"]["all_gather"] == gather, (moved["model"], gather)
        assert moved["model"]["reduce_scatter"] == scatter, (moved["model"], scatter)
    if arch in ("qwen2_moe_a2_7b", "zamba2_7b"):
        assert gather > 0


def test_sum_shards_all_reduces_forward_and_backward(runs):
    """``sum_shards``: the ranks' sum forward, and every rank's gradient the
    sum of the ranks' upstream gradients."""
    for res in runs["pair"]:
        c = res["collectives"]
        y, dx = c["sum_shards"]
        np.testing.assert_allclose(y, sum(c["xs"]), rtol=1e-6)
        np.testing.assert_allclose(dx, sum(g[:, :4] for g in c["gs"]), rtol=1e-6)


@pytest.mark.parametrize("name", ("gather_from", "gather_sum"))
def test_gathers_backward(runs, name):
    """Both gathers concatenate the ranks' shards; ``gather_from`` gives a
    rank its own part of its upstream gradient, ``gather_sum`` its part of
    the ranks' summed gradients."""
    for res in runs["pair"]:
        c, m = res["collectives"], res["mesh"]["index"]
        y, dx = c[name]
        np.testing.assert_array_equal(y, np.concatenate(c["xs"], axis=1))
        part = slice(4 * m, 4 * m + 4)
        want = c["gs"][m][:, part] if name == "gather_from" else sum(g[:, part]
                                                                    for g in c["gs"])
        np.testing.assert_allclose(dx, want, rtol=1e-6)


def test_sharded_rms_norm_is_the_whole_norm(runs):
    """The norm of rows split over the group: value and both gradients the
    whole norm's within 1e-6 of the gradient's scale."""
    for res in runs["pair"]:
        got = res["collectives"]["norm"]
        assert got["value"] < 1e-6 and got["dw"] < 1e-5 * got["scale"], got
        assert got["dx"] < 1e-6 * got["scale"], got


if __name__ == "__main__":
    _rank_main()
