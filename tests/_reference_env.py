"""The environment of a subprocess that runs the reference (JAX) on fake CPU
devices.

XLA's CPU collectives abort the whole process when a participant reaches a
rendezvous more than ``xla_cpu_collective_call_terminate_timeout_seconds``
(40 s by default) after the first one ("Termination timeout ... Expected 8
threads to join the rendezvous, but only 6 of them arrived on time", then
SIGABRT).  Under the whole suite's load a reference run has reached that
(``tests/test_torch_train_cli.py``'s 8-device run), while the same run
alone passes.  The subprocess's own deadline, which its test already
enforces, takes the place of XLA's: a stalled collective still fails the
test, by that deadline.
"""
import os
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def reference_env(deadline: int, devices: int = 0) -> dict:
    """``os.environ`` with the repo's ``src`` on the path, JAX on the CPU,
    ``devices`` fake devices (0: the flag left to the reference's own
    code) and XLA's collective termination timeout at ``deadline``
    seconds."""
    flags = [f"--xla_cpu_collective_call_terminate_timeout_seconds={int(deadline)}"]
    if devices:
        flags.insert(0, f"--xla_force_host_platform_device_count={devices}")
    return dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
                XLA_FLAGS=" ".join(flags))
