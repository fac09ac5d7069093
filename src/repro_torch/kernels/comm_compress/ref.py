"""Plain PyTorch versions of the codecs' ops: QSGD quantize / dequantize
and the top-k pack / unpack."""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "qsgd_quantize_ref", "qsgd_dequantize_ref", "top_k_pack_ref", "top_k_unpack_ref",
]


def qsgd_quantize_ref(x: torch.Tensor, u: torch.Tensor, levels) -> torch.Tensor:
    """sign(x) * min(floor(|x| * levels + u), levels) in fp32, in x's dtype.

    The product and the add are two roundings (no FMA), as in the
    reference and in the kernel, so the levels agree bit for bit."""
    xf = x.float()
    lv = float(np.float32(levels))
    q = torch.floor(xf.abs() * lv + u.float())
    return (torch.sign(xf) * torch.clamp(q, max=lv)).to(x.dtype)


def qsgd_dequantize_ref(q: torch.Tensor, scale: torch.Tensor, inv_levels) -> torch.Tensor:
    """q * scale * (1/levels) in fp32, in the SCALE's dtype (q is the int8
    payload on the codec's path)."""
    out = q.float() * scale.float() * float(np.float32(inv_levels))
    return out.to(scale.dtype)


def top_k_pack_ref(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """vals[i, j] = x[i, idx[i, j]]: the gather behind the packed payload."""
    return torch.gather(x, 1, idx.long())


def top_k_unpack_ref(idx: torch.Tensor, vals: torch.Tensor, d: int) -> torch.Tensor:
    """Dense (N, d) in vals' dtype: zeros, then a per-row scatter-add of
    vals at idx."""
    out = torch.zeros((idx.shape[0], int(d)), dtype=vals.dtype, device=vals.device)
    return out.scatter_add_(1, idx.long(), vals)
