"""The codecs' kernels: Triton for QSGD, CUDA C++ for the top-k payloads.

QSGD (Triton, below) replaces the TPU kernels ``repro/kernels/comm_compress/kernel.py::
qsgd_quantize_expr`` and ``::qsgd_dequantize_expr`` as launched by
``repro/kernels/api.py::_flat_launch``:

    qsgd_quantize    sign(x) * min(floor(|x| * L + u), L)   x = node-normalized
                                                           buffer, u ~ U[0, 1)
    qsgd_dequantize  q * scale * (1/L)                      q = int8 payload

Bound on the H100: HBM bytes.  quantize moves 2 reads + 1 write of fp32 per
element (12 bytes) against 5 operations; dequantize reads 1 int8 byte and
4 scale bytes and writes 4 (9 bytes) against 2 flops.  Design: one pass
over the one flat buffer of a dtype bucket; masked contiguous vector loads,
fp32 compute, cast on store; L and 1/L arrive as fp32 arguments.  The int8
payload is loaded as int8 and upcast in registers, so it costs one byte per
element.

Bit-exactness: the quantize kernel is compiled with ``enable_fp_fusion=
False``.  With fusion on, Triton contracts ``|x| * L + u`` into one FMA (one
rounding instead of two), and an element whose value lies within an ulp of
an integer then lands on the neighbouring level.  Without it the kernel
rounds the product and the sum separately, as the plain version does, and
the levels agree bit for bit.

Top-k pack / unpack (CUDA C++, ``repro_torch/csrc/top_k.cu``, whose header
says what they replace, their bound and their design): the wrappers here
check device, dtype, shape and contiguity, allocate the output (and the
unpack's sort scratch for rows longer than one tile) with ``torch.empty``,
launch on the current stream through ``ctypes`` and raise on a launch
error.  The library is compiled by ``nvcc`` on the first launch
(``kernels/_cuda.py``).  The wrappers are on the codecs' per-leaf path,
where a call costs its host time, so the checks that pass take one
expression and only a failing one walks ``_cuda.check_tensors`` for its
message.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _cuda, _triton

__all__ = ["launch_qsgd_quantize", "launch_qsgd_dequantize",
           "launch_top_k_pack", "launch_top_k_unpack", "UNPACK_TILE", "UNPACK_TILE_SHIFT",
           "PACK_SPLIT_BYTES", "pack_window", "unpack_scratch_bytes"]

BLOCK = 1024
tl = None   # triton.language, bound by _triton.jit on the first launch


def _qsgd_quantize_kernel(x_ptr, u_ptr, out_ptr, levels, n,
                          BLOCK: tl.constexpr, INT64: tl.constexpr):
    pid = tl.program_id(0)
    if INT64:
        pid = pid.to(tl.int64)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    x = tl.load(x_ptr + offs, mask=mask).to(tl.float32)
    u = tl.load(u_ptr + offs, mask=mask).to(tl.float32)
    q = tl.minimum(tl.floor(tl.abs(x) * levels + u), levels)
    sign = tl.where(x > 0, 1.0, tl.where(x < 0, -1.0, 0.0))
    tl.store(out_ptr + offs, (sign * q).to(out_ptr.dtype.element_ty), mask=mask)


def _qsgd_dequantize_kernel(q_ptr, scale_ptr, out_ptr, inv_levels, n,
                            BLOCK: tl.constexpr, INT64: tl.constexpr):
    pid = tl.program_id(0)
    if INT64:
        pid = pid.to(tl.int64)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    q = tl.load(q_ptr + offs, mask=mask).to(tl.float32)
    scale = tl.load(scale_ptr + offs, mask=mask).to(tl.float32)
    out = q * scale * inv_levels
    tl.store(out_ptr + offs, out.to(out_ptr.dtype.element_ty), mask=mask)


def launch_qsgd_quantize(scalars, ins, outs) -> None:
    """ins (x, u), outs (signed levels,); scalars (L,)."""
    n = _triton.check_flat("qsgd_quantize", ins, outs)
    (levels,) = scalars
    _triton.jit(_qsgd_quantize_kernel)[_triton.grid(n, BLOCK)](
        *ins, *outs, levels, n,
        BLOCK=BLOCK, INT64=_triton.needs_int64(n, BLOCK), num_warps=4,
        enable_fp_fusion=False,
    )


def launch_qsgd_dequantize(scalars, ins, outs) -> None:
    """ins (q int8, scale), outs (q * scale / L,); scalars (1/L,)."""
    n = _triton.check_flat("qsgd_dequantize", ins, outs)
    (inv_levels,) = scalars
    _triton.jit(_qsgd_dequantize_kernel)[_triton.grid(n, BLOCK)](
        *ins, *outs, inv_levels, n,
        BLOCK=BLOCK, INT64=_triton.needs_int64(n, BLOCK), num_warps=4,
    )


# ------------------------------------------------------- top-k (CUDA C++)
_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_TOP_K_FUNCTIONS = {
    "top_k_pack": (_P, _P, _P, _I64, _I64, _I64, _INT, _I64, _P),
    "top_k_unpack": (_P, _P, _P, _I64, _I64, _I64, _INT, _INT, _P, _I64, _P),
}
_PACK_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_UNPACK_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the unpack's output tile: 2**14 elements, a 64 KB fp32 accumulator in
# shared memory (every leaf of the paper's MLP is one tile)
UNPACK_TILE_SHIFT = 14
UNPACK_TILE = 1 << UNPACK_TILE_SHIFT
# the pack gathers a row of x of more than this many bytes in two passes,
# one over each half (on the H100 two passes beat one and three over rows of
# 33.5 and 67 MB: fewer misses in L2 against one more read of the row's idx)
PACK_SPLIT_BYTES = 20_000_000


def _top_k_lib():
    return _cuda.library("top_k", _TOP_K_FUNCTIONS)


def pack_window(d: int, elem_bytes: int) -> int:
    """Elements per window of the pack's passes over a row of d elements:
    half the row above ``PACK_SPLIT_BYTES``, else the whole row."""
    return max(1, -(-d // 2) if d * elem_bytes > PACK_SPLIT_BYTES else d)


def unpack_scratch_bytes(n: int, d: int, k: int, dtype: torch.dtype) -> int:
    """Bytes of sort scratch the unpack needs (0 for rows of one tile): the
    (row, tile) counts as uint32 (padded to 8 B), their bucket cursors as
    uint64, and one entry per kept element (8 B fp32, 4 B bf16), as
    ``top_k_unpack`` in ``csrc/top_k.cu`` lays them out."""
    tiles = -(-d // UNPACK_TILE)
    if tiles <= 1:
        return 0
    nt = n * tiles
    return (4 * nt + 7) // 8 * 8 + 8 * nt + n * k * (8 if dtype == torch.float32 else 4)


def launch_top_k_pack(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """vals (N, k) = x (N, d) gathered at int32 idx (N, k), in x's dtype."""
    if x.dim() != 2 or idx.dim() != 2 or idx.shape[0] != x.shape[0]:
        raise ValueError(f"top_k_pack: x (N, d) and idx (N, k), got {tuple(x.shape)} "
                         f"and {tuple(idx.shape)}")
    if not (x.is_cuda and idx.device == x.device and x.dtype in _PACK_DTYPES
            and idx.dtype == torch.int32 and x.is_contiguous() and idx.is_contiguous()):
        _cuda.check_tensors("top_k_pack", (("x", x, _PACK_DTYPES, None),
                                           ("idx", idx, (torch.int32,), None)))
    n, d = x.shape
    k = idx.shape[1]
    vals = torch.empty((n, k), dtype=x.dtype, device=x.device)
    eb = x.element_size()
    err = _top_k_lib().top_k_pack(x.data_ptr(), idx.data_ptr(), vals.data_ptr(), n, d, k, eb,
                                  pack_window(d, eb), _cuda.stream_of(x))
    if err:
        _cuda.check("top_k", "top_k_pack", err)
    return vals


def launch_top_k_unpack(idx: torch.Tensor, vals: torch.Tensor, d: int) -> torch.Tensor:
    """Dense (N, d) in vals' dtype: zeros, plus vals[i, j] at idx[i, j],
    summed in fp32 and rounded once."""
    if idx.dim() != 2:
        raise ValueError(f"top_k_unpack: idx must be (N, k), got {tuple(idx.shape)}")
    n, k = idx.shape
    d = int(d)
    if d < 0:
        raise ValueError(f"top_k_unpack: d must be >= 0, got {d}")
    if not (idx.is_cuda and vals.device == idx.device and idx.dtype == torch.int32
            and vals.dtype in _UNPACK_DTYPES and vals.shape == idx.shape
            and idx.is_contiguous() and vals.is_contiguous()):
        _cuda.check_tensors("top_k_unpack", (("idx", idx, (torch.int32,), None),
                                             ("vals", vals, tuple(_UNPACK_DTYPES), (n, k))))
    out = torch.empty((n, d), dtype=vals.dtype, device=vals.device)
    n_scratch = unpack_scratch_bytes(n, d, k, vals.dtype)
    scratch = torch.empty(n_scratch, dtype=torch.uint8, device=vals.device) if n_scratch else None
    err = _top_k_lib().top_k_unpack(
        idx.data_ptr(), vals.data_ptr(), out.data_ptr(), n, d, k, _UNPACK_DTYPES[vals.dtype],
        UNPACK_TILE_SHIFT, scratch.data_ptr() if n_scratch else None, n_scratch,
        _cuda.stream_of(vals))
    if err:
        _cuda.check("top_k", "top_k_unpack", err)
    return out
