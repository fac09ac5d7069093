"""Where the port runs: CUDA unless the caller asks for the CPU."""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "synchronize"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means CUDA.  Without a CUDA device this raises instead of moving
    to the CPU: the CPU runs only the plain PyTorch versions of the kernels,
    so it has to be asked for by name (``device="cpu"``).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU), so a host
    clock read afterwards times the work, not its enqueueing."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
