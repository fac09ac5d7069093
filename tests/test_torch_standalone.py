"""The port stands alone: no JAX, nothing of ``repro``, and no silent move to
the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.device import resolve_device
from repro_torch.paper_problem import make_algorithm, make_paper_problem, mlp_loss, run_method

_SRC = str(Path(__file__).resolve().parents[1] / "src")

_IMPORT_ALL = """
import pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    __import__(name)
for want in ("repro_torch.kernels.mvr_update.kernel", "repro_torch.kernels.comm_compress.kernel",
             "repro_torch.kernels.flash_attention.kernel", "repro_torch.kernels.rms_norm.kernel",
             "repro_torch.kernels.wkv_chunk.kernel", "repro_torch.models.rwkv",
             "repro_torch.models.transformer", "repro_torch.launch.serve",
             "repro_torch.scenarios", "repro_torch.scenarios.faults",
             "repro_torch.scenarios.heterogeneity", "repro_torch.scenarios.schedules",
             "repro_torch.scenarios.scenario", "repro_torch.scenarios.metrics",
             "repro_torch.runtime", "repro_torch.runtime.protocol",
             "repro_torch.runtime.config", "repro_torch.runtime.problems",
             "repro_torch.runtime.engine", "repro_torch.runtime.replay",
             "repro_torch.runtime.group", "repro_torch.runtime.chaos",
             "repro_torch.runtime.worker", "repro_torch.runtime.coordinator",
             "repro_torch.runtime.launch",
             "repro_torch.serving.snapshot", "repro_torch.serving.replicas",
             "repro_torch.serving.remote", "repro_torch.launch.mesh",
             "repro_torch.launch.distributed", "repro_torch.launch.sharding",
             "repro_torch.launch.shapes", "repro_torch.compression.gossip",
             "repro_torch.launch.train", "repro_torch.experiments",
             "repro_torch.experiments.sweep", "repro_torch.data.pipeline",
             "repro_torch.optim.optimizers"):
    assert want in names, (want, names)
assert "jax" not in sys.modules, "jax was imported"
leaked = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not leaked, leaked
assert "triton" not in sys.modules, "triton was imported before a launch"
from repro_torch.kernels import _cuda
assert not _cuda._loaded, "a CUDA library was loaded before a launch"
print(len(names))
"""


_EXAMPLES = Path(__file__).resolve().parents[1] / "examples"

_IMPORT_EXAMPLES = """
import importlib.util, sys
from pathlib import Path
names = sorted(Path(sys.argv[1]).glob("*_torch.py"))
for path in names:
    spec = importlib.util.spec_from_file_location(path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
assert "jax" not in sys.modules, "jax was imported"
leaked = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not leaked, leaked
assert "benchmarks" not in sys.modules and "triton" not in sys.modules
print(" ".join(p.stem for p in names))
"""


def test_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=_SRC)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 40


def test_examples_import_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=_SRC)
    out = subprocess.run([sys.executable, "-c", _IMPORT_EXAMPLES, str(_EXAMPLES)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["decentralized_lm_torch", "quickstart_torch",
                                  "scenario_robustness_torch", "serve_torch",
                                  "serve_while_training_torch"]


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_method("dse_mvr", 0.5, 4, 16, 4)
    from repro_torch.core import Simulator, ring

    data, _ = make_paper_problem(0.5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulator(make_algorithm("dse_mvr", 0.3, 4, 4), ring(8), mlp_loss, data, 16)
    from repro_torch.runtime import RuntimeConfig, simulate_reference
    from repro_torch.runtime.engine import WorkerEngine

    with pytest.raises(RuntimeError, match="device='cpu'"):
        WorkerEngine(RuntimeConfig(), 0, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate_reference(RuntimeConfig(n_rounds=1), [[True] * 8])
    assert resolve_device("cpu") == torch.device("cpu")


def test_unported_algorithms_point_at_the_roadmap():
    """Every algorithm and every gossip option is ported: the dense
    engine's and the sharded engine's wire modes and transport hooks (once
    refused, naming ROADMAP queue 1 item 8), each built with the
    reference's fields."""
    from repro_torch.compression import AsyncChannel, ChocoChannel, Transport
    from repro_torch.core import ALGORITHMS
    from repro_torch.core import make_algorithm as registry_make

    assert len(ALGORITHMS) == 8
    for name in ALGORITHMS:
        assert make_algorithm(name, 0.3, 4, 8).comm.resolved_channel() is None
    assert make_algorithm("dlsgd", 0.3, 4, 8, compression="top_k").comm.resolved_channel()
    assert make_algorithm("dse_mvr", 0.3, 4, 8, channel="choco").comm.resolved_channel()
    assert registry_make("gt_hsgd", lr=0.1, channel="async:2").comm.resolved_channel()
    assert registry_make("dse_mvr", lr=0.1, channel="choco", overlap=True).comm.channel.overlap
    assert registry_make("gt_hsgd", lr=0.1, channel={"y": "sync"}).comm.resolved_channel() is None
    from repro.compression import AsyncChannel as JAsyncChannel
    from repro.compression import ChocoChannel as JChocoChannel
    from repro.compression import Transport as JTransport
    from repro.core import make_algorithm as j_registry_make

    got = make_algorithm("dse_mvr", 0.3, 4, 8, channel=ChocoChannel(neighbor_shifts=(1, -1)))
    assert got.comm.resolved_channel().neighbor_shifts == \
        JChocoChannel(neighbor_shifts=(1, -1)).neighbor_shifts
    got = registry_make("gt_hsgd", lr=0.1, channel=AsyncChannel(replicated_wire=True))
    want = j_registry_make("gt_hsgd", lr=0.1, channel=JAsyncChannel(replicated_wire=True))
    assert got.comm.resolved_channel().tag == want.comm.resolved_channel().tag
    assert got.comm.resolved_channel().replicated_wire == \
        want.comm.resolved_channel().replicated_wire
    got, want = ChocoChannel(overlap=True, defer_roll=True), \
        JChocoChannel(overlap=True, defer_roll=True)
    assert (got.tag, got.overlap, got.defer_roll) == (want.tag, want.overlap, want.defer_roll)
    gather = lambda p: p  # noqa: E731
    assert Transport(lambda t: t, gather_payload=gather).gather_payload is \
        JTransport(lambda t: t, gather_payload=gather).gather_payload is gather
