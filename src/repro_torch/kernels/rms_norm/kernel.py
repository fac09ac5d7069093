"""The fused RMSNorm's launcher: a ``ctypes`` wrapper of the CUDA C++ kernel
``repro_torch/csrc/rms_norm.cu``, whose header says what it replaces
(``repro/kernels/rms_norm/kernel.py::rms_norm_fwd``), what bounds it on the
H100 and how it is built.

The wrapper checks shapes, dtypes, device and contiguity, allocates y with
``torch.empty_like``, launches on the current stream and raises on a launch
error.  The kernel picks its path itself: a warp per row with the row in
registers, or a scalar warp-per-row loop for a width that is not a multiple
of its 16-byte vector, a view that does not start on a 16-byte boundary,
or a row too wide for its registers.  The library is compiled by ``nvcc``
on the first launch (``kernels/_cuda.py``).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _cuda

__all__ = ["launch_rms_norm"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P, _INT = ctypes.c_void_p, ctypes.c_int
_FUNCTIONS = {"rms_norm_fwd": (_P, _P, _P, ctypes.c_longlong, _INT, _INT, _INT, _INT,
                               ctypes.c_float, _P)}


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
    lib = _cuda.library("rms_norm", _FUNCTIONS)
    err = lib.rms_norm_fwd(x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, d,
                           _DTYPES[x.dtype], _DTYPES[weight.dtype], int(bool(plus_one)),
                           float(eps), _cuda.stream_of(x))
    _cuda.check("rms_norm", "rms_norm", err)
    return out
