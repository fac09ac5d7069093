"""How far two roundings of one tensor-parallel function lie apart, on the
CPU, at the reduced configs of the four archs whose default profile is tp.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/tp_numerics_probe.py \
        [noise] [grad] [reference] [nan]

``noise``: the port's DSE-MVR round (tau 3, lr 0.01, alpha 0.1, 2 nodes at
model 1, bf16 activations) from the model's init plus 0.05 N(0, 1), against
the same round from that init moved one fp32 ulp up: the largest gap in the
sharded band (rtol 5e-3, atol 1e-4) and its leaf, by arch.

``grad``: on a 2-rank gloo group, the tensor-parallel model's gradients
against the whole model's, in fp32 and in fp64 (the model's fp32 casts
kept fp64), over draws of the init's perturbation: by draw, each of the
largest gaps relative to a leaf's largest gradient -- tp against whole in
fp32, each fp32 gradient against the fp64 whole one, and tp against whole
in fp64.

``reference``: the reference's own tp job on a (2, 2) mesh against its job
on a (2, 1) mesh (model 1), one DSE-MVR round in bf16 activations, same
init and batches: the largest gap in the sharded band, by arch (runs the
reference in two subprocesses on fake CPU devices).

``nan``: Mamba-2's training backward on a 128-token chunk of the reduced
Zamba2 block, inputs of scale 4: whether the reference's (a subprocess)
and the port's forward and gradient are finite.

Prints JSON lines.  Uses ``tests/test_torch_layout_blocks.py``'s helpers.
"""
import json
import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT / "src"))
import test_torch_layout_blocks as T  # noqa: E402
from _reference_env import reference_env  # noqa: E402

BAND = dict(rtol=5e-3, atol=1e-4)
DRAWS = 8


def _band_gap(a, b) -> float:
    return float(np.max(np.abs(a - b) / (BAND["atol"] + BAND["rtol"] * np.abs(b))))


def _leaf_names(cfg) -> list:
    from repro_torch.models import Model

    names = []

    def walk(t, path=""):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}/{k}")
        else:
            names.append(path)

    walk(Model(cfg).param_shapes())
    return names


def noise() -> None:
    from repro_torch.launch.distributed import make_train_job
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

    torch.set_num_threads(4)
    for arch in T.ARCHS:
        cfg = T._config(arch)
        rng = np.random.default_rng(0)
        job = make_train_job(cfg, make_test_mesh(T.NODES, device="cpu"), profile="tp",
                             **T.HYPER)
        leaves, treedef = tree_flatten(job.model.init(0, device="cpu"))
        leaves = [w + 0.05 * torch.as_tensor(rng.standard_normal(tuple(w.shape)),
                                             dtype=w.dtype) for w in leaves]
        shape = (T.TAU, T.NODES, T.B, T.S)
        batches = {"targets": torch.as_tensor(rng.integers(0, cfg.vocab_size, shape))}
        if cfg.audio_frontend_dim:
            frames = rng.standard_normal(shape + (cfg.audio_frontend_dim,))
            batches["frames"] = torch.as_tensor(frames, dtype=torch.bfloat16)
        else:
            batches["tokens"] = torch.as_tensor(rng.integers(0, cfg.vocab_size, shape))
        after = []
        for moved in (False, True):
            init = [torch.nextafter(w, torch.full_like(w, float("inf"))) if moved else w
                    for w in leaves]
            state = job.init_state(0, params=tree_unflatten(treedef, init))
            state, _ = job.step_fn(state, job.local_batch(batches))
            after.append([t.numpy() for t in tree_leaves(state.params)])
        gaps = [_band_gap(a, b) for a, b in zip(after[1], after[0])]
        worst = int(np.argmax(gaps))
        print(json.dumps({"noise": arch, "band_gap": gaps[worst],
                          "leaf": _leaf_names(cfg)[worst]}), flush=True)


GRAD_RANK = """
import datetime, json, sys
import numpy as np, torch, torch.distributed as dist
sys.path.insert(0, {tests!r}); sys.path.insert(0, {src!r})
import test_torch_layout_blocks as T
from repro_torch.launch.distributed import make_train_job
from repro_torch.launch.mesh import make_group_mesh
from repro_torch.tree import tree_flatten, tree_unflatten

rank, store, case, draws = int(sys.argv[1]), sys.argv[2], sys.argv[3], int(sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=300))
mesh = make_group_mesh(1, device="cpu", model=2)
cfg = T._config(case)
job = make_train_job(cfg, mesh, profile="tp")
base, treedef = tree_flatten(job.model.init(0, device="cpu"))
f32, f64 = torch.float32, torch.float64
for draw in range(draws):
    rng = np.random.default_rng(draw)
    whole = [w + 0.05 * torch.as_tensor(rng.standard_normal(tuple(w.shape)), dtype=w.dtype)
             for w in base]
    shards = T._local(whole, job.shard_dims, mesh.model_group.index)
    batch = {{"targets": torch.as_tensor(rng.integers(0, cfg.vocab_size, (T.B, T.S))),
              "tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (T.B, T.S)))}}
    got = {{}}
    with T.float64_throughout() as wide:
        for dt in (f32, f64):
            wide[0] = dt == f64
            for tag, leaves, tp in (("whole", whole, None), ("tp", shards, mesh.model_group)):
                ps = [p.detach().to(dt).requires_grad_(True) for p in leaves]
                loss = job.model.loss(tree_unflatten(treedef, ps), batch, dtype=dt, tp=tp)
                got[tag, dt] = torch.autograd.grad(loss, ps, materialize_grads=True)
    local = lambda gs: T._local(list(gs), job.shard_dims, mesh.model_group.index)

    def worst(a, b):
        return max(float((x.double() - y.double()).abs().max())
                   / max(float(y.abs().max()), 1e-30) for x, y in zip(a, b))

    exact = local(got["whole", f64])
    out = {{"grad": case, "draw": draw, "rank": rank,
           "tp_vs_whole_fp32": worst(got["tp", f32], local(got["whole", f32])),
           "whole_fp32_vs_fp64": worst(local(got["whole", f32]), exact),
           "tp_fp32_vs_fp64": worst(got["tp", f32], exact),
           "tp_vs_whole_fp64": worst(got["tp", f64], exact)}}
    print(json.dumps(out), flush=True)
dist.destroy_process_group()
"""


def grad(case: str = "zamba2_7b") -> None:
    code = GRAD_RANK.format(tests=str(ROOT / "tests"), src=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        env = dict(os.environ, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen([sys.executable, "-c", code, str(r), store, case, str(DRAWS)],
                                  env=env, stdout=subprocess.PIPE, text=True) for r in range(2)]
        outs = [p.communicate(timeout=900)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        print(out, end="", flush=True)


REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_reduced
from repro.launch.distributed import make_train_job
from repro.launch.mesh import make_test_mesh
from repro.launch.sharding import PROFILES

model, out = int(sys.argv[1]), sys.argv[2]
mesh = make_test_mesh((2, model), ("data", "model"))
rng = np.random.default_rng(0)
res = {{}}
for arch in {archs}:
    cfg = get_reduced(arch)
    job = make_train_job(cfg, mesh, gossip="roll", profile=PROFILES["tp"], **{hyper})
    shape = ({tau}, 2, {b}, {s})
    batch = {{"targets": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}}
    if cfg.audio_frontend_dim:
        batch["frames"] = jnp.asarray(rng.standard_normal(shape + (cfg.audio_frontend_dim,)),
                                      jnp.bfloat16)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    p0 = jax.tree.map(lambda x: np.asarray(x) + np.float32(0.05) * rng.standard_normal(
        x.shape).astype(np.float32), job.model.init(jax.random.key(0)))
    stacked = jax.tree.map(lambda p: jnp.broadcast_to(jnp.asarray(p)[None], (2,) + p.shape), p0)
    step = jax.jit(job.step_fn, in_shardings=(job.state_shardings, job.batch_shardings),
                   out_shardings=(job.state_shardings, None))
    state, _ = step(job.algorithm.init(stacked), {{k: jnp.asarray(v) for k, v in batch.items()}})
    for i, leaf in enumerate(jax.tree.leaves(state.params)):
        res[arch + "/" + str(i)] = np.asarray(leaf)
np.savez(out, **res)
"""


def reference() -> None:
    code = textwrap.dedent(REFERENCE.format(archs=T.ARCHS, hyper=T.HYPER, tau=T.TAU, b=T.B,
                                            s=T.S))
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for model in (2, 1):
            paths[model] = os.path.join(tmp, f"model{model}.npz")
            env = reference_env(900, devices=2 * model)
            subprocess.run([sys.executable, "-c", code, str(model), paths[model]], env=env,
                           check=True, timeout=900)
        two, one = np.load(paths[2]), np.load(paths[1])
        for arch in T.ARCHS:
            keys = [k for k in two.files if k.startswith(arch + "/")]
            gap = max(_band_gap(two[k], one[k]) for k in keys)
            print(json.dumps({"reference": arch, "band_gap_tp_vs_model1": gap}), flush=True)


NAN_REFERENCE = """
import dataclasses, jax, jax.numpy as jnp
from repro.configs import get_reduced
from repro.models import mamba
from repro.models.common import Initializer
cfg = dataclasses.replace(get_reduced("zamba2_7b").mamba_cfg(), chunk=128)
p = mamba.init_mamba(cfg, Initializer("params", jax.random.key(0)))
u = 4 * jax.random.normal(jax.random.key(1), (1, 256, cfg.d_model))
f = lambda p: jnp.mean(mamba.mamba_forward(cfg, p, u) ** 2)
g = jax.grad(f)(p)
print(bool(jnp.isfinite(f(p))), all(bool(jnp.isfinite(x).all()) for x in jax.tree.leaves(g)))
"""


def nan() -> None:
    """Mamba-2's training backward on a 128-token chunk, inputs of scale 4
    (the reduced Zamba2 block): the reference's forward is finite and its
    gradient is not; the port's both."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.models import mamba
    from repro_torch.models.common import Initializer

    out = subprocess.run([sys.executable, "-c", NAN_REFERENCE], env=reference_env(300),
                         capture_output=True, text=True, check=True, timeout=300).stdout.split()
    cfg = dataclasses.replace(get_reduced("zamba2_7b").mamba_cfg(), chunk=128)
    gen = torch.Generator().manual_seed(0)
    params = {k: v.requires_grad_(True)
              for k, v in mamba.init_mamba(cfg, Initializer(gen)).items()}
    y = mamba.mamba_forward(cfg, params, 4 * torch.randn(1, 256, cfg.d_model, generator=gen))
    grads = torch.autograd.grad(y.square().mean(), list(params.values()))
    print(json.dumps({"nan": "mamba2_chunk128",
                      "reference_finite_forward": out[0] == "True",
                      "reference_finite_gradient": out[1] == "True",
                      "port_finite_forward": bool(torch.isfinite(y).all()),
                      "port_finite_gradient": all(bool(torch.isfinite(g).all())
                                                  for g in grads)}), flush=True)


if __name__ == "__main__":
    modes = sys.argv[1:] or ["noise", "grad", "reference", "nan"]
    for mode in modes:
        {"noise": noise, "grad": grad, "reference": reference, "nan": nan}[mode]()
