"""Triton kernel for the fused RMSNorm.

Replaces the TPU kernel ``repro/kernels/rms_norm/kernel.py::rms_norm_fwd``
(its body ``_rms_kernel``):

    y = x * rsqrt(mean(x^2) + eps) * (w or w + 1)     per row, fp32 reduction

Bound on the H100: HBM bytes.  One read of x and one write of y (plus the
d weights once), against 4 operations per element: at Gemma-2's rows of
d_model = 2304 in bf16, 16,384 rows move 151 MB, 0.045 ms at 3.35 TB/s.
Design: one program per row; the whole row (d rounded up to a power of two
and masked, not padded) is one block held in registers, so x is read once,
squared and summed in fp32, scaled and stored in x's dtype.  The TPU
kernel's 256-row tiles and ``ops.py``'s row padding have no counterpart:
every row is its own program, so any row count works.  The reduction order
is Triton's tree, not the plain version's, and rsqrt is the hardware's
approximation (relative error about 2^-23), so fp32 outputs differ from the
plain version by an ulp or two.
"""
from __future__ import annotations

import torch

from .. import _triton

__all__ = ["launch_rms_norm"]

tl = None   # triton.language, bound by _triton.jit on the first launch
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _rms_norm_kernel(x_ptr, w_ptr, out_ptr, d, eps,
                     PLUS_ONE: tl.constexpr, BLOCK: tl.constexpr, INT64: tl.constexpr):
    row = tl.program_id(0)
    if INT64:
        row = row.to(tl.int64)
    cols = tl.arange(0, BLOCK)
    mask = cols < d
    x = tl.load(x_ptr + row * d + cols, mask=mask, other=0.0).to(tl.float32)
    var = tl.sum(x * x, axis=0) / d
    w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    if PLUS_ONE:
        w = w + 1.0
    y = x * tl.rsqrt(var + eps) * w
    tl.store(out_ptr + row * d + cols, y.to(out_ptr.dtype.element_ty), mask=mask)


def launch_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
                    plus_one: bool = False) -> torch.Tensor:
    """y in x's shape and dtype: every row of x (..., d) normalized, one
    launch over all rows."""
    if x.dim() < 1 or weight.shape != (x.shape[-1],):
        raise ValueError(f"rms_norm: x (..., d) and weight (d,), got {tuple(x.shape)} "
                         f"and {tuple(weight.shape)}")
    for label, t in (("x", x), ("weight", weight)):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError("rms_norm: x and weight must be on one CUDA device")
        if t.dtype not in _DTYPES:
            raise ValueError(f"rms_norm: unsupported {label} dtype {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"rms_norm: {label} must be contiguous")
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    out = torch.empty_like(x)
    if rows == 0:
        return out
    block = 1 << max(4, (d - 1).bit_length())
    _triton.jit(_rms_norm_kernel)[(rows,)](
        x, weight, out, d, float(eps),
        PLUS_ONE=bool(plus_one), BLOCK=block, INT64=_triton.needs_int64(rows * d, block),
        num_warps=max(1, min(16, block // 256)),
    )
    return out
