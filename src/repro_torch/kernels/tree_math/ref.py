"""Plain PyTorch versions of ``axpby`` and ``add_sub``."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["axpby_ref", "add_sub_ref"]


def axpby_ref(x: torch.Tensor, y: torch.Tensor, a, b) -> torch.Tensor:
    """a*x + b*y in fp32, cast to y's dtype."""
    out = float(np.float32(a)) * x.float() + float(np.float32(b)) * y.float()
    return out.to(y.dtype)


def add_sub_ref(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a + b - c in fp32, cast to a's dtype."""
    return (a.float() + b.float() - c.float()).to(a.dtype)
