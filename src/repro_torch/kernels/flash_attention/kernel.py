"""The flash-attention forward's launcher: a ``ctypes`` wrapper of the CUDA
C++ kernels in ``repro_torch/csrc/flash_attention.cu``, whose header says
what they replace (``repro/kernels/flash_attention/kernel.py::
flash_attention_fwd``), what bounds them on the H100 and how they are built:
in bf16 at D = 128 and 256 a warp-specialised kernel that loads by TMA and
multiplies by ``wgmma``, at D = 32 and 64 an ``mma.sync`` one, and in fp32 a
kernel of plain FMAs.  A head dim between those instances is zero-padded to
the next one (Zamba2's 112 to 128, the wgmma kernel, whose TMA boxes are
64 columns of 128 bytes): zero columns add nothing to q.k, the scale stays
1/sqrt(D) of the true D, the output's extra columns are zero and are sliced
off.  The kernel then does the next instance's work (128/112 = 1.14x at
Zamba2's heads) and the padding costs one copy of q, k and v.

The wrapper checks device, dtype, shapes, contiguity and alignment, allocates
the output with ``torch.empty``, launches on the current stream and raises
on a launch error, a refused shared-memory size or a failed tensor-map
encode alike; nothing falls back to another kernel or the plain version.
The library is compiled by ``nvcc`` on the first launch (``kernels/_cuda.py``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import _cuda

__all__ = ["launch_flash_attention", "HEAD_DIMS", "kernel_head_dim"]

HEAD_DIMS = (32, 64, 128, 256)   # the kernel's template instances
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _INT, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FUNCTIONS = {
    "flash_attention_fwd": (_P, _P, _P, _P) + (_INT,) * 8 + (_F, _F, _INT, _P),
}


def kernel_head_dim(d: int) -> int:
    """The template instance a head dim runs on: the smallest that holds it."""
    if not 0 < d <= HEAD_DIMS[-1]:
        raise ValueError(f"flash_attention: head_dim {d} not in (0, {HEAD_DIMS[-1]}]")
    return next(n for n in HEAD_DIMS if n >= d)


def launch_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           causal: bool = True, sliding_window: Optional[int] = None,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """out (B, Sq, H, D) in q's dtype, from q (B, Sq, H, D) and k, v
    (B, Skv, K, D), H a multiple of K; fp32 or bf16, D at most 256 (a D
    between ``HEAD_DIMS`` is padded to the next one, and the output is a
    view of the padded kernel's)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q (B, S, H, D) and k, v (B, S, K, D), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kh == 0 or h % kh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit k {tuple(k.shape)}")
    dk = kernel_head_dim(d)
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"flash_attention: sliding_window must be >= 1, got {sliding_window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got {softcap}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: unsupported dtype {q.dtype}")
    dtypes = (q.dtype,)
    _cuda.check_tensors("flash_attention", (("q", q, dtypes, None),
                                            ("k", k, dtypes, None),
                                            ("v", v, dtypes, tuple(k.shape))))
    if dk != d:
        q, k, v = (torch.nn.functional.pad(t, (0, dk - d)) for t in (q, k, v))
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must start on a 16-byte boundary")
    out = torch.empty_like(q)
    lib = _cuda.library("flash_attention", _FUNCTIONS)
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, kh, sq, skv, dk,
        int(causal), int(sliding_window or 0), float(softcap or 0.0), 1.0 / math.sqrt(d),
        _DTYPES[q.dtype], _cuda.stream_of(q))
    _cuda.check("flash_attention", "flash_attention", err)
    return out if dk == d else out[..., :d]
