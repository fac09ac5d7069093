"""Two probes of the frozen reference on fake CPU devices, behind the
training CLI's parity test and the '2d' layout's tests.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python3 scripts/reference_load_probe.py \
        copies [--copies 4] [--use-fused] [--deadline 400]
    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python3 scripts/reference_load_probe.py layouts

``copies``: starts ``--copies`` copies of ``tests/test_torch_train_cli.py``'s
reference subprocess side by side (8 fake devices each, its runs and
flags; ``--use-fused`` puts the reference's fused-op flag back on its
runs) and prints, for each, its exit code, its seconds and whether XLA
reported a collective rendezvous stuck (a copy that passes ``--deadline``
is killed: its seconds are null).

``layouts``: one DSGD step of lr 1 (whose update is the gradient) of the
reference's '2d' job on reduced Arctic 480B and reduced Command R+ 104B in
fp32 activations, on meshes of one to three axes, each against the same
job on one device: the leaves whose update lies more than 1e-3 of its
largest entry from the one-device job's, and for those the largest update
of each expert.  Runs the reference in a subprocess on 8 fake devices.

Prints JSON lines.
"""
import argparse
import json
import subprocess
import sys
import tempfile
import textwrap
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tests"))

LAYOUTS = """
import json
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_reduced
from repro.launch.distributed import make_train_job
from repro.launch.mesh import make_test_mesh
from repro.launch.sharding import PROFILES
from repro.models import Model

loss = Model.loss
Model.loss = lambda self, params, batch, dtype=None: loss(self, params, batch, jnp.float32)
MESHES = [((1, 1), ("data", "model")), ((4, 2), ("data", "model")),
          ((2, 4), ("data", "model")), ((4, 1), ("data", "model")),
          ((1, 8), ("data", "model")), ((8, 1), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model")), ((2, 1, 4), ("pod", "data", "model"))]
for arch in ("arctic_480b", "command_r_plus_104b"):
    cfg = get_reduced(arch)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 1, 1, 4, 16))
    p0 = jax.tree.map(lambda x: np.asarray(x) + np.float32(0.05) * np.random.default_rng(
        1).standard_normal(x.shape).astype(np.float32), Model(cfg).init(jax.random.key(0)))
    names = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(p0)[0]]
    base = None
    for shape, axes in MESHES:
        mesh = make_test_mesh(shape, axes)
        job = make_train_job(cfg, mesh, gossip="roll", profile=PROFILES["2d"],
                             algorithm="dsgd", tau=1, lr=1.0)
        n = job.n_nodes
        batch = {k: jnp.asarray(np.broadcast_to(t, (1, n, 4, 16)).astype(np.int32))
                 for k, t in zip(("tokens", "targets"), tokens)}
        stacked = jax.tree.map(lambda p: jnp.broadcast_to(jnp.asarray(p)[None], (n,) + p.shape),
                               p0)
        step = jax.jit(job.step_fn, in_shardings=(job.state_shardings, job.batch_shardings),
                       out_shardings=(job.state_shardings, None))
        state, _ = step(job.algorithm.init(stacked), batch)
        update = [np.asarray(x) - np.asarray(y)[0]
                  for x, y in zip(jax.tree.leaves(p0), jax.tree.leaves(state.params))]
        if base is None:
            base = update
        off = {name: [float(np.abs(a[:, e]).max()) for e in range(a.shape[1])]
                     if "ffn" in name and a.ndim == 4 else float(np.abs(a).max())
               for name, a, b in zip(names, update, base)
               if np.abs(a - b).max() > 1e-3 * np.abs(b).max()}
        print(json.dumps({"arch": arch, "mesh": dict(zip(axes, shape)), "nodes": n,
                          "off": off}), flush=True)
"""


def copies(args) -> None:
    import test_torch_train_cli as cli
    from _reference_env import reference_env

    runs = {tag: (cli._reference_flags(cli.FLAGS + extra), False, False)
            for tag, extra in cli.RUNS.items()}
    runs["arctic"] = (cli._reference_flags(cli.ARCTIC), False, True)
    runs["arctic_one_device"] = (cli._reference_flags(cli.ARCTIC), True, True)
    if args.use_fused:
        runs = {tag: (flags + ["--use-fused"], one, fp32) for tag, (flags, one, fp32) in
                runs.items()}
    env = reference_env(args.deadline, devices=8)
    with tempfile.TemporaryDirectory() as tmp:
        procs, logs, ends = [], [], {}
        t0 = time.perf_counter()
        for i in range(args.copies):
            logs.append(open(f"{tmp}/copy{i}.log", "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", textwrap.dedent(cli.REFERENCE), f"{tmp}/copy{i}",
                 json.dumps(runs)], env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
        while len(ends) < len(procs) and time.perf_counter() - t0 < args.deadline:
            for i, p in enumerate(procs):
                if i not in ends and p.poll() is not None:
                    ends[i] = time.perf_counter() - t0
            time.sleep(0.5)
        for i, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
                p.wait()
            logs[i].seek(0)
            print(json.dumps({"copy": i, "use_fused": args.use_fused, "rc": p.returncode,
                              "seconds": round(ends[i], 1) if i in ends else None,
                              "stuck_rendezvous": "may be stuck" in logs[i].read()}),
                  flush=True)
            logs[i].close()


def layouts(args) -> None:
    from _reference_env import reference_env

    subprocess.run([sys.executable, "-c", textwrap.dedent(LAYOUTS)],
                   env=reference_env(600, devices=8), check=True, timeout=900)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("probe", choices=("copies", "layouts"))
    ap.add_argument("--copies", type=int, default=4)
    ap.add_argument("--use-fused", action="store_true")
    ap.add_argument("--deadline", type=float, default=400)
    args = ap.parse_args()
    {"copies": copies, "layouts": layouts}[args.probe](args)


if __name__ == "__main__":
    main()
