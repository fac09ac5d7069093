"""Triton kernels for the QSGD codec's per-element hot paths.

Replace the TPU kernels ``repro/kernels/comm_compress/kernel.py::
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
"""
from __future__ import annotations

from .. import _triton

__all__ = ["launch_qsgd_quantize", "launch_qsgd_dequantize"]

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
