"""The mesh-sharded serve job (``make_serve_job(cfg, mesh)``) on spawned gloo
groups, against the reference's (2, 2) serve job and against the port's
one-device job.

  * Against the reference: one subprocess runs the reference's
    ``make_serve_job`` on 4 fake CPU devices, mesh (2, 2), for the reduced
    Gemma-2 2B, RWKV-6 3B (the plain chunked wkv form, ``rwkv_chunk=16``),
    Zamba2-7B, Qwen1.5-MoE-A2.7B and Qwen2-VL-2B (text prompts), jitted
    with its own ``param_shardings`` and the ``cache_specs`` shardings, as
    its ``lower_prefill`` / ``lower_decode`` build them: a prefill of B x S
    tokens, then STEPS greedy decode steps from the prefill's caches.  Both
    sides run fp32 activations (``Model.prefill`` and ``Model.decode_step``
    wrapped; the jobs ask for bf16).  A 4-rank group (2 data ranks x model
    2) serves the same parameters and prompts: the logits of each rank's
    rows after the prefill and after each step within rtol 1e-4 / atol
    1e-5, the greedy tokens exactly, each rank's cache shard within the
    same band of the matching slice of the reference's caches (``pos``
    exactly), and the MoE's routes exactly the reference's (recorded from
    its prefill and steps run eagerly on the same tokens).
  * Against the one-device job on the whole batch, in fp32: logits and
    cache shards within 1e-5; every model rank of a data rank gets the same
    logits, bit for bit; the MoE's routes and kept entries exactly.
  * The MoE at a capacity factor that drops entries (``DROPS``): the data
    ranks queue the whole batch once, as the reference's job does, so the
    logits, the routes and the kept entries are the reference's and the
    one-device job's on the whole batch; a queue of a data rank's rows
    alone gives other logits.
  * The same group as one data rank x model 4: Gemma-2's and Qwen2-VL's 2
    KV heads do not divide by 4, so their caches keep every KV head on
    every rank (each rank writes all of them; the same bits on every
    rank).  A batch of 3 on 2 data ranks: every data rank serves all 3
    rows.  Zamba2's conv window after the steps: each rank's contiguous
    block of the channels.  A ``RequestDriver`` on the job, each data rank
    driving its half of the slots.  Arctic 480B (its training profile
    '2d') serves under the serve rules.
  * The model group's bytes for one decode step: the fp32 all-reduces each
    block makes and the gathers (the logits', the MoE router's, Mamba-2's
    projection, conv weights and window), to the byte.
  * ``mesh=None`` is the one-device job: its functions are the model's
    own, bit for bit; the entry points raise without a card unless the CPU
    is asked for.

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
    GROUP_DEADLINE, PROCESS_DEADLINE, _nest, _spawn_group,
)

ARCHS = ("gemma2_2b", "rwkv6_3b", "zamba2_7b", "qwen2_moe_a2_7b", "qwen2_vl_2b")
DROPS = "qwen2_moe_drops"                # the MoE at a capacity factor that drops entries
# each run: (arch, changes); RWKV-6 through the plain chunked form of the
# wkv recurrence, on both sides
RUNS = {**{a: (a, {}) for a in ARCHS}, "rwkv6_3b": ("rwkv6_3b", dict(rwkv_chunk=16)),
        DROPS: ("qwen2_moe_a2_7b", dict(capacity_factor=0.5))}
MOE_RUNS = ("qwen2_moe_a2_7b", DROPS)
DATA, MODEL = 2, 2
B, S, STEPS = 4, 16, 4
WIDE = ("gemma2_2b", "qwen2_vl_2b")      # one data rank x model 4: replicated KV heads
LM_BAND = dict(rtol=1e-4, atol=1e-5)     # the repo's LM band against the reference
SELF_TOL = 1e-5                          # against the one-device job, fp32


def _config(run: str):
    from repro_torch.configs import get_reduced

    arch, changes = RUNS.get(run, (run, {}))
    return dataclasses.replace(get_reduced(arch), **changes)


# ------------------------------------------------------------ the rank side
@contextlib.contextmanager
def fp32_serving():
    """``Model.prefill`` and ``Model.decode_step`` in fp32 activations
    whatever dtype the job asks for."""
    from repro_torch.models import Model

    prefill, decode = Model.prefill, Model.decode_step
    Model.prefill = lambda self, p, b, dtype=None, tp=None, data=None: prefill(
        self, p, b, torch.float32, tp, data)
    Model.decode_step = lambda self, p, c, t, pos, dtype=None, tp=None, data=None: decode(
        self, p, c, t, pos, torch.float32, tp, data)
    try:
        yield
    finally:
        Model.prefill, Model.decode_step = prefill, decode


@contextlib.contextmanager
def recording_routes(routes: list):
    """Every MoE routing's experts and kept mask, (tokens, k) each."""
    from repro_torch.models import mlp

    route = mlp._route

    def record(*args, **kw):
        out = route(*args, **kw)
        k = out[3].shape[-1]
        routes.append((out[3].reshape(-1, k).numpy(), out[5].reshape(-1, k).numpy()))
        return out

    mlp._route = record
    try:
        yield
    finally:
        mlp._route = route


def _flat(tree) -> dict:
    from repro_torch.tree import tree_flatten

    leaves, treedef = tree_flatten(tree)
    names = _names(treedef)
    return {n: t.detach().numpy() for n, t in zip(names, leaves)}


def _names(treedef, prefix="") -> list:
    if treedef is None:
        return [prefix]
    out = []
    for k, child in treedef:
        out += _names(child, f"{prefix}['{k}']")
    return out


def serve(mesh, cfg, params, batch, steps=STEPS, tokens=None) -> dict:
    """The job of ``cfg`` on ``mesh`` (None: one device) in fp32
    activations: the prefill of ``batch`` (the whole batch; the job takes
    this data rank's rows) and ``steps`` decode steps from its caches, on
    the greedy tokens (or on ``tokens``, the whole batch's, a step each).
    Returns the rows, each step's logits and tokens, the caches after the
    prefill and after the steps (with their layout), the MoE's routes and
    the model group's bytes of the first decode step (and the mesh's)."""
    from repro_torch.launch.serve import make_serve_job
    from repro_torch.tree import tree_leaves

    routes: list = []
    with fp32_serving(), recording_routes(routes):
        job = make_serve_job(cfg, mesh, device=None if mesh is not None else "cpu")
        p = job.shard_params(params)
        whole = next(iter(batch.values())).shape[0]
        rows = job.rows(whole)
        logits, caches = job.prefill_fn(p, job.local_batch(batch), global_batch=whole)
        out = {"rows": (rows.start, rows.stop), "logits": [logits.numpy()], "tokens": [],
               "prefill_cache": _flat(caches), "bytes": None, "mesh_bytes": None}
        s = batch["tokens"].shape[1] + cfg.n_vision_tokens
        for i in range(steps):
            tok = (logits[:, -1].argmax(-1) if tokens is None
                   else torch.as_tensor(tokens[i])[rows]).to(torch.int32)
            out["tokens"].append(tok.numpy())
            pos = torch.full((tok.shape[0],), s + i, dtype=torch.int32)
            group = None if mesh is None else mesh.model_group
            if group is not None and i == 0:
                mesh.reset_bytes()
            logits, caches = job.decode_fn(p, caches, tok[:, None], pos, global_batch=whole)
            if group is not None and i == 0:
                out["bytes"] = group.byte_counts()
                out["mesh_bytes"] = mesh.byte_counts()
            out["logits"].append(logits.numpy())
        out["cache"] = _flat(caches)
        if mesh is not None:
            # the layout of the whole batch's caches (shapes decide what divides)
            empty = job.model.init_cache(whole, 1, device="cpu")
            out["layout"] = dict(zip(_flat(caches), tree_leaves(job.cache_layout(empty))))
    out["routes"] = routes
    return out


def _whole_params(npz, arch):
    from repro_torch.convert import params_from_numpy

    return params_from_numpy(_nest(npz, arch + "/params"), "cpu")


def _batch(npz, arch) -> dict:
    return {k.split("/")[-1]: torch.as_tensor(npz[k]) for k in npz.files
            if k.startswith(arch + "/batch/")}


def drive(mesh, cfg, params, one: bool) -> dict:
    """A ``RequestDriver`` of 4 slots on the job (``one``: the one-device
    job, all slots) over 8 requests: a data rank drives its half of the
    slots and its half of the requests.  Each request's greedy tokens and
    the driver's steps."""
    from repro_torch.launch.serve import make_serve_job
    from repro_torch.serving import RequestDriver

    rng = np.random.default_rng(3)
    requests = [(rng.integers(0, cfg.vocab_size, int(n)), 5) for n in rng.integers(3, 7, 8)]
    with fp32_serving():
        job = make_serve_job(cfg, None if one else mesh, device="cpu" if one else None)
        driver = RequestDriver(job.model, slots=4, max_len=16, job=None if one else job,
                               decode_fn=job.decode_fn, device="cpu" if one else None)
        mine = list(range(8)) if one else list(range(mesh.rank, 8, mesh.world))
        res = driver.run(job.shard_params(params), [requests[i] for i in mine])
    return {"slots": driver.slots, "steps": res["steps"],
            "outputs": {i: res["outputs"][k] for k, i in enumerate(mine)}}


def _rank_main(argv=None) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_group_mesh
    from repro_torch.launch.serve import make_serve_job

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
        square = make_group_mesh(DATA, device="cpu", model=MODEL)
        wide = make_group_mesh(1, device="cpu", model=args.world)
        res = {"mesh": {"data": square.rank, "index": square.model_group.index},
               "square": {}, "one": {}, "wide": {}}
        for run in RUNS:
            cfg, params, batch = _config(run), _whole_params(npz, run), _batch(npz, run)
            res["square"][run] = serve(square, cfg, params, batch)
            res["one"][run] = serve(None, cfg, params, batch, tokens=[
                npz[f"{run}/tokens/{i}"] for i in range(STEPS)])
            if run in WIDE:
                res["wide"][run] = serve(wide, cfg, params, batch)
        cfg, params = _config("gemma2_2b"), _whole_params(npz, "gemma2_2b")
        three = {k: v[:3] for k, v in _batch(npz, "gemma2_2b").items()}
        res["three"] = {"square": serve(square, cfg, params, three),
                        "one": serve(None, cfg, params, three)}
        # the dropping MoE with a queue of this data rank's rows alone
        got = res["square"][DROPS]
        rows = slice(*got["rows"])
        res["rows"] = serve(None, _config(DROPS), _whole_params(npz, DROPS),
                            {k: v[rows] for k, v in _batch(npz, DROPS).items()},
                            tokens=got["tokens"])
        res["driver"] = {"square": drive(square, cfg, params, False),
                         "one": drive(None, cfg, params, True)}
        # the whole batch's row count is required on 2 data ranks, and checked
        job = make_serve_job(cfg, square)
        rows = job.local_batch(_batch(npz, "gemma2_2b"))
        res["refused"] = []
        for kw in ({}, {"global_batch": 2}):
            try:
                job.prefill_fn(job.shard_params(params), rows, **kw)
            except ValueError as e:
                res["refused"].append(str(e))
        # the '2d' training profile's arch serves under the serve rules
        acfg = _config("arctic_480b")
        job = make_serve_job(acfg, square)
        whole = job.model.init(0, dtype=torch.float32, device="cpu")
        tokens = {"tokens": torch.as_tensor(np.random.default_rng(4).integers(
            0, acfg.vocab_size, (B, S)))}
        res["arctic"] = {"profile": job.profile.name,
                         "square": serve(square, acfg, whole, tokens, steps=1),
                         "one": serve(None, acfg, whole, tokens, steps=1)}
        torch.save(res, args.out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------- the parent side
REFERENCE = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_reduced
from repro.launch.distributed import _named, make_serve_job
from repro.launch.mesh import make_test_mesh
from repro.launch.sharding import cache_specs
from repro.models import Model
from repro.models import mlp as jmlp

prefill, decode = Model.prefill, Model.decode_step
Model.prefill = lambda self, p, b, dtype=None: prefill(self, p, b, jnp.float32)
Model.decode_step = lambda self, p, c, t, pos, dtype=None: decode(self, p, c, t, pos, jnp.float32)
routes, recording_on = [], [False]
dispatch = jmlp._dispatch_compute_combine


def kept(oh, capacity):
    # the experts and the kept entries, as the dispatch queues them
    oh = np.asarray(oh)
    t, k, e = oh.shape
    flat = oh.reshape(t * k, e)
    pos = ((np.cumsum(flat, 0) - flat) * flat).sum(-1).reshape(t, k)
    return oh.argmax(-1), pos < capacity


def recording(cfg, params, tokens, capacity, constrain=True):
    out = dispatch(cfg, params, tokens, capacity, constrain)
    if recording_on[0]:   # inside the layers' scan: a callback a layer, in order
        jax.debug.callback(lambda oh: routes.append(kept(oh, capacity)), out[2], ordered=True)
    return out


jmlp._dispatch_compute_combine = recording
mesh = make_test_mesh(({data}, {model}), ("data", "model"))
rng = np.random.default_rng(0)
res = {{}}


def save(prefix, tree):
    for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        res[prefix + jax.tree_util.keystr(k)] = np.asarray(v)


for tag, (arch, change) in {runs}:
    cfg = dataclasses.replace(get_reduced(arch), **change)
    job = make_serve_job(cfg, mesh)
    params = job.model.init(jax.random.key(0))
    save(tag + "/params/", params)
    batch = {{"tokens": rng.integers(0, cfg.vocab_size, ({b}, {s})).astype(np.int32)}}
    if cfg.n_vision_tokens:
        batch["vision_embeds"] = rng.standard_normal(
            ({b}, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    for k, v in batch.items():
        res[tag + "/batch/" + k] = v
    # lower_prefill's shardings: the batch over the data axis
    b_shard = {{k: NamedSharding(mesh, P("data", *([None] * (v.ndim - 1))))
               for k, v in batch.items()}}
    p_dev = jax.device_put(params, job.param_shardings)
    pf = jax.jit(job.prefill_fn, in_shardings=(job.param_shardings, b_shard))
    logits, caches = pf(p_dev, jax.device_put(batch, b_shard))
    save(tag + "/prefill_cache/", caches)
    # lower_decode's: the caches by cache_specs, the tokens over the data axis
    c_shard = _named(mesh, cache_specs(caches, ("data",), mesh=mesh))
    t_shard, s_shard = NamedSharding(mesh, P("data", None)), NamedSharding(mesh, P("data"))
    step = jax.jit(job.decode_fn, in_shardings=(job.param_shardings, c_shard, t_shard, s_shard),
                   out_shardings=(None, c_shard))
    caches = jax.device_put(caches, c_shard)
    start = {s} + cfg.n_vision_tokens
    toks = []
    res[tag + "/logits/0"] = np.asarray(logits)
    for i in range({steps}):
        tok = np.asarray(logits[:, -1]).argmax(-1).astype(np.int32)
        toks.append(tok)
        pos = np.full(({b},), start + i, np.int32)
        logits, caches = step(p_dev, caches, jax.device_put(tok[:, None], t_shard),
                              jax.device_put(pos, s_shard))
        res[tag + "/logits/" + str(i + 1)] = np.asarray(logits)
        res[tag + "/tokens/" + str(i)] = tok
    save(tag + "/cache/", caches)
    if "moe" in cfg.block_unit:
        # the routes, eagerly on the same tokens
        routes.clear()
        recording_on[0] = True
        model = job.model
        lg, cc = model.prefill(params, {{k: jnp.asarray(v) for k, v in batch.items()}})
        for i, tok in enumerate(toks):
            lg, cc = model.decode_step(params, cc, jnp.asarray(tok[:, None]),
                                       jnp.full(({b},), start + i, jnp.int32))
        jax.effects_barrier()
        recording_on[0] = False
        for i, (experts, keep) in enumerate(routes):
            res[tag + "/routes/" + str(i)] = experts
            res[tag + "/kept/" + str(i)] = keep
np.savez(sys.argv[1], **res)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's serve jobs (a subprocess), then the 4-rank group,
    run once for the module."""
    tmp = tmp_path_factory.mktemp("serve_layout")
    ref_npz = tmp / "reference.npz"
    env = reference_env(GROUP_DEADLINE, devices=DATA * MODEL)
    code = textwrap.dedent(REFERENCE.format(
        data=DATA, model=MODEL, b=B, s=S, steps=STEPS,
        runs=tuple(RUNS.items())))
    ref = subprocess.run([sys.executable, "-c", code, str(ref_npz)], env=env,
                         capture_output=True, text=True, timeout=GROUP_DEADLINE)
    assert ref.returncode == 0, (ref.stdout + ref.stderr)[-4000:]
    group = _spawn_group(DATA * MODEL, tmp, ("--ref", str(ref_npz)), script=__file__)
    return {"group": group, "ref": np.load(ref_npz)}


def _cut(whole: np.ndarray, spec, d: int, m: int, data: int, model: int) -> np.ndarray:
    """The part of a whole cache leaf that a rank (data index d, model
    index m) holds under its spec."""
    for dim, ax in enumerate(spec):
        axes = () if ax is None else (ax,) if isinstance(ax, str) else tuple(ax)
        for a in axes:
            size, i = (model, m) if a == "model" else (data, d)
            n = whole.shape[dim] // size
            whole = np.take(whole, range(i * n, (i + 1) * n), axis=dim)
    return whole


def _ranks(runs):
    for r, res in enumerate(runs["group"]):
        yield r, res, divmod(r, MODEL)


@pytest.mark.parametrize("arch", RUNS)
def test_serve_matches_the_reference(runs, arch):
    """Each rank's rows of the logits after the prefill and after every
    decode step within rtol 1e-4 / atol 1e-5 of the reference's (2, 2) serve
    job, and the greedy tokens exactly."""
    ref = runs["ref"]
    for _, res, _ in _ranks(runs):
        got = res["square"][arch]
        rows = slice(*got["rows"])
        assert rows.stop - rows.start == B // DATA
        for i, logits in enumerate(got["logits"]):
            np.testing.assert_allclose(logits, ref[f"{arch}/logits/{i}"][rows], **LM_BAND,
                                       err_msg=f"step {i}")
        for i, tok in enumerate(got["tokens"]):
            np.testing.assert_array_equal(tok, ref[f"{arch}/tokens/{i}"][rows])


@pytest.mark.parametrize("arch", RUNS)
def test_cache_shards_match_the_reference(runs, arch):
    """Each rank's cache shard after the prefill and after the steps is the
    matching slice of the reference's caches (``cache_specs``' layout)
    within the band; the positions exactly."""
    ref = runs["ref"]
    for _, res, (d, m) in _ranks(runs):
        got = res["square"][arch]
        for tag in ("prefill_cache", "cache"):
            for name, leaf in got[tag].items():
                want = _cut(ref[f"{arch}/{tag}/{name}"], got["layout"][name], d, m, DATA, MODEL)
                assert leaf.shape == want.shape, (tag, name, leaf.shape, want.shape)
                if name.endswith("['pos']"):
                    np.testing.assert_array_equal(leaf, want)
                else:
                    np.testing.assert_allclose(leaf, want, **LM_BAND, err_msg=f"{tag} {name}")


def _steps(ref, key: str) -> list:
    return [ref[k] for k in sorted((k for k in ref.files if k.startswith(key)),
                                   key=lambda k: int(k.rsplit("/", 1)[1]))]


@pytest.mark.parametrize("arch", MOE_RUNS)
def test_moe_routes_match_the_reference(runs, arch):
    """The MoE routes every token of a rank's rows to the reference's
    experts and keeps the reference's entries (its prefill and steps, run
    on the same tokens), as the one-device job does on the whole batch:
    nothing drops at the reduced capacity factor, and at ``DROPS``' the
    queues over the whole batch drop entries, at the prefill and at a
    decode step."""
    ref = runs["ref"]
    want, want_kept = _steps(ref, arch + "/routes/"), _steps(ref, arch + "/kept/")
    for _, res, _ in _ranks(runs):
        got, one = res["square"][arch], res["one"][arch]
        assert len(got["routes"]) == len(want) == len(want_kept) == len(one["routes"]) > 0
        lo, hi = got["rows"]
        for i, ((experts, keep), whole, kept, (e1, k1)) in enumerate(
                zip(got["routes"], want, want_kept, one["routes"])):
            per = whole.shape[0] // B                  # tokens a row at this call
            np.testing.assert_array_equal(experts, whole[lo * per:hi * per], err_msg=str(i))
            np.testing.assert_array_equal(keep, kept[lo * per:hi * per], err_msg=str(i))
            np.testing.assert_array_equal(experts, e1[lo * per:hi * per])
            np.testing.assert_array_equal(keep, k1[lo * per:hi * per])
        if arch == DROPS:
            n = len(got["routes"]) // (STEPS + 1)      # MoE layers a call
            assert not all(k.all() for k in want_kept[:n])        # the prefill drops
            assert not all(k.all() for k in want_kept[n:])        # and a decode step
        else:
            assert all(k.all() for k in want_kept)


def test_moe_queues_the_whole_batch(runs):
    """At a capacity factor that drops entries, the data ranks' MoE queues
    the whole batch once: a queue of a data rank's rows alone (against a
    capacity of its own tokens) keeps other entries and gives other
    logits than the job, which are the whole batch's
    (``test_moe_routes_match_the_reference``)."""
    for _, res, _ in _ranks(runs):
        got, alone = res["square"][DROPS], res["rows"]
        assert any(not np.array_equal(k, k1)
                   for (_, k), (_, k1) in zip(got["routes"], alone["routes"]))
        assert not all(np.allclose(g, w, rtol=SELF_TOL, atol=SELF_TOL)
                       for g, w in zip(got["logits"], alone["logits"]))


@pytest.mark.parametrize("arch", RUNS)
def test_serve_matches_the_one_device_job(runs, arch):
    """In fp32 each rank's logits and cache shards are the one-device job's
    (on the whole batch, the same tokens) within 1e-5."""
    for _, res, (d, m) in _ranks(runs):
        got, one = res["square"][arch], res["one"][arch]
        rows = slice(*got["rows"])
        for g, w in zip(got["logits"], one["logits"]):
            np.testing.assert_allclose(g, w[rows], rtol=SELF_TOL, atol=SELF_TOL)
        for tag in ("prefill_cache", "cache"):
            for name, leaf in got[tag].items():
                want = _cut(one[tag][name], got["layout"][name], d, m, DATA, MODEL)
                np.testing.assert_allclose(leaf, want, rtol=SELF_TOL, atol=SELF_TOL,
                                           err_msg=f"{tag} {name}")


@pytest.mark.parametrize("arch", RUNS)
def test_model_ranks_get_the_same_logits(runs, arch):
    """Every model rank of a data rank gets the same whole-vocabulary logits,
    bit for bit, so the greedy tokens are the same on the group."""
    group = runs["group"]
    for r, res, (d, m) in _ranks(runs):
        first = group[d * MODEL]["square"][arch]
        for g, w in zip(res["square"][arch]["logits"], first["logits"]):
            np.testing.assert_array_equal(g, w)
        for g, w in zip(res["square"][arch]["tokens"], first["tokens"]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("arch", WIDE)
def test_replicated_kv_heads(runs, arch):
    """One data rank x model 4: the 2 KV heads do not divide by 4, so every
    rank's cache holds all of them (``cache_specs`` keeps ``k``/``v``
    replicated), each written by every rank, the same bits on every rank
    and the one-device job's within 1e-5; the logits too."""
    group = runs["group"]
    for r, res in enumerate(group):
        got, one = res["wide"][arch], res["one"][arch]
        k_names = [n for n in got["cache"] if n.endswith(("['k']", "['v']"))]
        assert k_names
        for name in k_names:
            assert "model" not in got["layout"][name], got["layout"][name]
            assert got["cache"][name].shape == one["cache"][name].shape
            np.testing.assert_array_equal(got["cache"][name], group[0]["wide"][arch]["cache"][name])
        for tag in ("prefill_cache", "cache"):
            for name, leaf in got[tag].items():
                want = _cut(one[tag][name], got["layout"][name], 0, r, 1, DATA * MODEL)
                np.testing.assert_allclose(leaf, want, rtol=SELF_TOL, atol=SELF_TOL)
        assert got["rows"] == (0, B)
        for g, w in zip(got["logits"], one["logits"]):
            np.testing.assert_allclose(g, w, rtol=SELF_TOL, atol=SELF_TOL)
        for g, w in zip(got["tokens"], one["tokens"]):
            np.testing.assert_array_equal(g, w)


def test_batch_not_divisible_serves_every_row(runs):
    """A batch of 3 on 2 data ranks: every data rank serves all 3 rows, its
    caches hold them all, and its logits are the one-device job's."""
    for _, res, (d, m) in _ranks(runs):
        got, one = res["three"]["square"], res["three"]["one"]
        assert got["rows"] == (0, 3)
        for g, w in zip(got["logits"], one["logits"]):
            assert g.shape[0] == 3
            np.testing.assert_allclose(g, w, rtol=SELF_TOL, atol=SELF_TOL)
        for name, leaf in got["cache"].items():
            assert leaf.shape[1] == 3
            np.testing.assert_allclose(leaf, _cut(one["cache"][name], got["layout"][name], d, m,
                                                  DATA, MODEL), rtol=SELF_TOL, atol=SELF_TOL)


def test_conv_window_is_the_ranks_block_of_channels(runs):
    """Zamba2's conv window after the decode steps: each rank holds its
    contiguous block of the [x | B | C] channels (``cache_specs``' layout,
    not its heads' channels), the one-device window's within 1e-5."""
    cfg = _config("zamba2_7b")
    mcfg = cfg.mamba_cfg()
    channels = mcfg.d_inner + 2 * mcfg.state_dim
    for _, res, (d, m) in _ranks(runs):
        got, one = res["square"]["zamba2_7b"], res["one"]["zamba2_7b"]
        conv = [n for n in got["cache"] if n.endswith("['conv']")]
        assert len(conv) == 2
        for name in conv:
            assert got["layout"][name] == (None, ("data",), None, "model")
            leaf = got["cache"][name]
            assert leaf.shape[-1] == channels // MODEL
            whole = one["cache"][name][:, d * 2:(d + 1) * 2]
            part = whole[..., m * leaf.shape[-1]:(m + 1) * leaf.shape[-1]]
            np.testing.assert_allclose(leaf, part, rtol=SELF_TOL, atol=SELF_TOL)
            assert np.abs(part).max() > 0


def _decode_bytes(cfg, b: int) -> dict:
    """What a rank receives over the model group in one fp32 decode step of
    ``b`` rows at model 2: an fp32 all-reduce of the embedding's lookups,
    of each row-parallel output (attention's ``wo``, each MLP's
    ``w_down``, the experts', Mamba-2's ``w_out``, RWKV-6's ``w_o`` and
    channel mix) and of each sharded norm's statistic; all-gathers of the
    head's logits, the MoE router's logits, and Mamba-2's projection
    columns, conv weights and conv window."""
    peers, d, f = MODEL - 1, cfg.d_model, 4
    reduce = b * d * f                             # the embedding
    gather = b * cfg.vocab_size // MODEL * f      # the logits
    for kind in cfg.block_unit:
        n = cfg.repeats              # a shared element too: applied every repeat
        if kind == "rwkv":
            reduce += n * (b * f + 2 * b * d * f)
        elif kind == "mamba":
            m = cfg.mamba_cfg()
            cols = (2 * m.d_inner + 2 * m.state_dim + m.n_heads) // MODEL
            chans = (m.d_inner + 2 * m.state_dim) // MODEL
            reduce += n * (b * f + b * d * f)
            gather += n * (b * cols * f + m.conv_width * chans * f
                           + b * (m.conv_width - 1) * chans * f)
        else:
            reduce += n * 2 * b * d * f                        # wo and the MLP / experts
            if kind == "moe":
                reduce += n * b * d * f                        # the shared experts
                gather += n * b * (cfg.n_experts // MODEL) * f  # the router's logits
    return {"all_reduce": peers * reduce, "all_gather": peers * gather}


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_bytes(runs, arch):
    """The model group's bytes of one decode step are the blocks' fp32
    all-reduces and the gathers, to the byte; nothing is reduce-scattered.
    Over the data ranks a MoE layer exchanges its E per-expert counts
    (int64), and nothing else moves."""
    cfg = _config(arch)
    want = _decode_bytes(cfg, B // DATA)
    counts = (DATA - 1) * cfg.repeats * cfg.block_unit.count("moe") * cfg.n_experts * 8
    for _, res, _ in _ranks(runs):
        moved = res["square"][arch]["bytes"]
        assert moved["reduce_scatter"] == moved["codec"] == moved["payload"] == 0
        assert {k: moved[k] for k in want} == want, (moved, want)
        mesh = {op: c for op, c in res["square"][arch]["mesh_bytes"].items() if op != "model"}
        assert mesh == {"roll": {"node_link": 0, "process": 0},
                        "all_gather": {"node_link": 0, "process": counts},
                        "all_reduce": {"node_link": 0, "process": 0}}, mesh


def test_request_driver_on_the_job(runs):
    """A ``RequestDriver`` on the job: each data rank drives 2 of the 4
    slots and its half of the requests, and the data ranks step together
    (their requests' lengths differ); every request's greedy tokens are
    the one-device driver's."""
    steps = {res["driver"]["square"]["steps"] for res in runs["group"]}
    assert len(steps) == 1, steps
    for _, res, (d, m) in _ranks(runs):
        got, one = res["driver"]["square"], res["driver"]["one"]
        assert got["slots"] == 2 and one["slots"] == 4
        assert sorted(got["outputs"]) == list(range(d, 8, DATA))
        for i, toks in got["outputs"].items():
            np.testing.assert_array_equal(toks, one["outputs"][i])


def test_global_batch_is_required_on_data_ranks(runs):
    """On 2 data ranks the job's functions refuse rows without the whole
    batch's row count, and rows that are not the data rank's block of it."""
    for _, res, _ in _ranks(runs):
        no, wrong = res["refused"]
        assert "global_batch" in no
        assert "2 rows are not data rank" in wrong


def test_2d_profile_arch_serves(runs):
    """Arctic 480B's training profile is '2d', which the training job
    refuses on a model axis; its serve job takes the serve rules and serves
    as the one-device job does."""
    for _, res, _ in _ranks(runs):
        got = res["arctic"]
        assert got["profile"] == "2d"
        rows = slice(*got["square"]["rows"])
        for g, w in zip(got["square"]["logits"], got["one"]["logits"]):
            np.testing.assert_allclose(g, w[rows], rtol=SELF_TOL, atol=SELF_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_device_job_is_the_models_own(arch):
    """``mesh=None``: the prefill and decode functions are the model's
    ``prefill`` and ``decode_step`` in bf16, bit for bit, the caches
    ``init_cache``'s, the shards the whole tree, no layout."""
    from repro_torch.launch.serve import make_serve_job
    from repro_torch.tree import tree_leaves

    cfg = _config(arch)
    job = make_serve_job(cfg, device="cpu")
    assert job.mesh is None and job.rows(3) == slice(0, 3)
    params = job.init_params(0)
    assert job.shard_params(params) is params
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 8)))}
    if cfg.n_vision_tokens:
        batch["vision_embeds"] = torch.as_tensor(
            rng.standard_normal((2, cfg.n_vision_tokens, cfg.d_model)), dtype=torch.float32)
    with torch.inference_mode():
        want = job.model.prefill(params, batch, dtype=torch.bfloat16)
        cache = job.model.init_cache(2, 16, device="cpu")
        step = job.model.decode_step(params, cache, batch["tokens"][:, :1],
                                     torch.zeros(2, dtype=torch.int32), dtype=torch.bfloat16)
    got = job.prefill_fn(params, job.local_batch(batch))
    got_step = job.decode_fn(params, job.init_cache(2, 16), batch["tokens"][:, :1],
                             torch.zeros(2, dtype=torch.int32))
    for g, w in zip([got[0], got_step[0]] + tree_leaves({"p": got[1], "d": got_step[1]}),
                    [want[0], step[0]] + tree_leaves({"p": want[1], "d": step[1]})):
        assert torch.equal(g, w)
    assert job.param_layout is None


def test_entry_points_raise_without_cuda():
    """Without a card the job, its mesh and the driver raise unless the CPU
    is asked for; a device other than the mesh's is refused."""
    from repro_torch.launch.mesh import NodeMesh
    from repro_torch.launch.serve import make_serve_job
    from repro_torch.serving import RequestDriver

    cfg = _config("gemma2_2b")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_serve_job(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NodeMesh(1)
    job = make_serve_job(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RequestDriver(job.model, slots=2, max_len=8)
    with pytest.raises(ValueError, match="mesh"):
        make_serve_job(cfg, NodeMesh(1, device="cpu"), device="cuda")


if __name__ == "__main__":
    _rank_main()
