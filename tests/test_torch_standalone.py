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
assert "repro_torch.kernels.mvr_update.kernel" in names, names
assert "repro_torch.kernels.comm_compress.kernel" in names, names
assert "jax" not in sys.modules, "jax was imported"
leaked = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not leaked, leaked
assert "triton" not in sys.modules, "triton was imported before a launch"
from repro_torch.kernels import _cuda
assert not _cuda._loaded, "a CUDA library was loaded before a launch"
print(len(names))
"""


def test_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=_SRC)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


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
    assert resolve_device("cpu") == torch.device("cpu")


def test_unported_algorithms_point_at_the_roadmap():
    """Every algorithm and every gossip option of the dense engine is
    ported; what the sharded engine alone needs (its wire modes and
    transport hooks) raises and names the ROADMAP item."""
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
    for fn in (lambda: make_algorithm("dse_mvr", 0.3, 4, 8,
                                      channel=ChocoChannel(neighbor_shifts=(1, -1))),
               lambda: registry_make("gt_hsgd", lr=0.1,
                                     channel=AsyncChannel(replicated_wire=True)),
               lambda: ChocoChannel(overlap=True, defer_roll=True),
               lambda: Transport(lambda t: t, gather_payload=lambda p: p)):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
            fn()
