"""Plain PyTorch version of the fused MVR direction update (Alg. 1 line 16).

v_new = g_new + (1 - alpha) * (v - g_old), computed in fp32, cast to v.dtype.
"""
from __future__ import annotations

import numpy as np
import torch


def mvr_update_ref(g_new: torch.Tensor, v: torch.Tensor, g_old: torch.Tensor, alpha) -> torch.Tensor:
    one_minus = float(np.float32(1.0) - np.float32(alpha))   # fp32, as the reference
    out = g_new.float() + one_minus * (v.float() - g_old.float())
    return out.to(v.dtype)
