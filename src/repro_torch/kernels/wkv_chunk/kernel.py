"""The chunked wkv recurrence's launcher: a ``ctypes`` wrapper of the CUDA
C++ kernel ``repro_torch/csrc/wkv_chunk.cu``, whose header says what it
replaces (``repro/kernels/wkv_chunk/kernel.py::wkv_chunk_fwd``), what bounds
it on the H100 and how it is built.

The wrapper checks shapes, dtypes, device, contiguity and the chunk,
allocates y, the final state and the kernel's scratch (each group's state
increment and decay product) with ``torch.empty``, launches the kernel's
three passes on the current stream and raises on a launch error.  An input
whose data does not start on a 16-byte boundary (a view at an odd offset)
is copied once, since the kernel reads rows in 16-byte pieces.  The library
is compiled by ``nvcc`` on the first launch (``kernels/_cuda.py``).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _cuda

__all__ = ["launch_wkv_chunk", "group_size", "HEAD_SIZES", "MAX_CHUNK", "GROUP_TOKENS"]

HEAD_SIZES = (16, 32, 64)   # the kernel's template instances
MAX_CHUNK = 64
# tokens in a group of chunks: 16 chunks of 16 give RWKV-6 3B's full-width
# call 2,560 blocks a pass and a carry of 32 groups (csrc/wkv_chunk.cu)
GROUP_TOKENS = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _INT = ctypes.c_void_p, ctypes.c_int
_FUNCTIONS = {"wkv_chunk_fwd": (_P,) * 7 + (_INT,) * 8 + (_P,)}


def group_size(chunk: int) -> int:
    """Chunks in one group of the kernel's passes A and C."""
    return max(1, GROUP_TOKENS // chunk)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch_wkv_chunk(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
                     chunk: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, H, P) fp32, final state (B, H, P, P) fp32) from r, k, v
    (B, S, H, P) in one dtype (fp32 or bf16) and logw (B, S, H, P) in fp32
    or r's dtype; P in ``HEAD_SIZES``, 1 <= chunk <= 64, S % chunk == 0.
    The state starts at zero."""
    if r.dim() != 4:
        raise ValueError(f"wkv_chunk: r, k, v, logw are (B, S, H, P), got {tuple(r.shape)}")
    b, s, h, p = r.shape
    if p not in HEAD_SIZES:
        raise ValueError(f"wkv_chunk: head size {p} not in {HEAD_SIZES}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"wkv_chunk: chunk {chunk} not in [1, {MAX_CHUNK}]")
    if s % chunk:
        raise ValueError(f"wkv_chunk: sequence length {s} is not a multiple of chunk {chunk}")
    if r.dtype not in _DTYPES:
        raise ValueError(f"wkv_chunk: unsupported dtype {r.dtype}")
    _cuda.check_tensors("wkv_chunk", (("r", r, (r.dtype,), None),
                                      ("k", k, (r.dtype,), tuple(r.shape)),
                                      ("v", v, (r.dtype,), tuple(r.shape)),
                                      ("logw", logw, (torch.float32, r.dtype), tuple(r.shape))))
    r, k, v, logw = (_aligned(t) for t in (r, k, v, logw))
    group = group_size(chunk)
    n_groups = -(-(s // chunk) // group)
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=r.device)
    state = torch.empty((b, h, p, p), dtype=torch.float32, device=r.device)
    scratch = torch.empty((b, h, n_groups, p * p + p), dtype=torch.float32, device=r.device)
    lib = _cuda.library("wkv_chunk", _FUNCTIONS)
    err = lib.wkv_chunk_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), y.data_ptr(),
        state.data_ptr(), scratch.data_ptr(), b, s, h, p, chunk, group, _DTYPES[r.dtype],
        _DTYPES[logw.dtype], _cuda.stream_of(r))
    _cuda.check("wkv_chunk", "wkv_chunk", err)
    return y, state
