"""The port's example scripts (``examples/*_torch.py``) run end to end on
the CPU at their smoke sizes, with their own assertions live, and refuse to
run without a card unless the CPU is asked for."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
SCRIPTS = ("quickstart_torch", "scenario_robustness_torch", "serve_torch",
           "serve_while_training_torch", "decentralized_lm_torch")
SMOKE_ARGS = {
    "decentralized_lm_torch": ["--steps", "1", "--tau", "2"],
    "quickstart_torch": ["--smoke"],
    "scenario_robustness_torch": ["--smoke"],
    "serve_torch": ["--tokens", "4"],
    "serve_while_training_torch": ["--smoke"],
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's many small ops: beside other
    test workers, a pool of one OpenMP thread per core oversubscribes the
    CPU and spins, which slows these runs by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_quickstart_smoke_on_cpu():
    out = _load("quickstart_torch").main(["--device", "cpu", "--smoke"])
    assert set(out) == {"DSGD", "GT-DSGD", "DLSGD", "DSE-SGD", "DSE-MVR"}
    for m in out.values():
        assert 0.0 < m["train_loss"] < 2.5 and 0.1 < m["test_acc"] <= 1.0


def test_scenario_robustness_smoke_on_cpu():
    out = _load("scenario_robustness_torch").main(["--device", "cpu", "--smoke"])
    assert len(out) == 6 and all(np.isfinite(v) for v in out.values())


def test_serve_on_cpu():
    tokens = _load("serve_torch").main(["--device", "cpu", "--tokens", "4"])
    assert tokens.shape == (4, 4)


@pytest.mark.parametrize("codec,bounds", [("qsgd", "1,4"), ("top_k:0.1", "1,2")])
def test_serve_while_training_smoke_on_cpu(codec, bounds):
    """The example's own asserts: the SLO holds and the identity mirror is
    the live node mean bit for bit; bound b moves 1/b of bound 1's bytes."""
    out = _load("serve_while_training_torch").main(
        ["--device", "cpu", "--smoke", "--codec", codec, "--bounds", bounds])
    assert all(row["ok"] for row in out["slo"])
    b = int(bounds.split(",")[1])
    kb = out["link_bytes"]
    assert kb[1] == pytest.approx(kb[0] / 4 if b == 4 else kb[0] / 2)


def test_decentralized_lm_on_cpu(tmp_path):
    """The example registers its config as a module of the port's registry
    and trains it through the CLI: lm-20m, one round of tau 2."""
    from repro_torch.configs import get_config

    hist = _load("decentralized_lm_torch").main(
        ["--device", "cpu", "--steps", "1", "--tau", "2", "--use-fused", "--out", str(tmp_path)])
    assert [h["round"] for h in hist] == [1] and np.isfinite(hist[0]["loss"])
    assert get_config("lm-20m").d_model == 256
    assert (tmp_path / "history.json").exists()


@pytest.mark.parametrize("name", SCRIPTS)
def test_examples_need_cuda_unless_cpu_is_asked_for(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _load(name).main(SMOKE_ARGS[name])
