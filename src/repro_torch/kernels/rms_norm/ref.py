"""Plain PyTorch version of the fused RMSNorm (the counterpart of
``repro.kernels.rms_norm.ref.rms_norm_ref``): fp32 reduction and scale,
output in x's dtype."""
from __future__ import annotations

import torch

__all__ = ["rms_norm_ref"]


def rms_norm_ref(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
                 plus_one: bool = False) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    w = weight.float()
    if plus_one:
        w = w + 1.0
    return (y * w).to(x.dtype)
