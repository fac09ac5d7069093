"""Triton kernels for the fused dual-slow combine (Alg. 1 lines 7-9).

Replace the TPU kernels ``repro/kernels/dse_combine/kernel.py::
dse_combine_expr`` and ``::dse_combine_yh_expr`` as launched by
``repro/kernels/api.py::_flat_launch``:

    h = x_ref - (params - gamma * v)
    u = z + h                  (fused-z state)
    u = y + h - h_prev         ((y, h_prev) state)

Bound on the H100: HBM bytes.  4 reads + 2 writes (fused-z) or 5 reads +
2 writes per element against 4-5 flops (~0.2 flop/byte in fp32).  Design:
one pass over the one flat buffer of a dtype bucket that writes BOTH
outputs, as the TPU kernel does, so neither x_half nor h makes a second trip
through HBM; masked contiguous vector loads, fp32 compute, cast on store
(u in z's or y's dtype, h in v's); gamma arrives as an fp32 argument.
"""
from __future__ import annotations

from .. import _triton

__all__ = ["launch_dse_combine", "launch_dse_combine_yh"]

BLOCK = 1024
tl = None   # triton.language, bound by _triton.jit on the first launch


def _dse_combine_kernel(p_ptr, v_ptr, x_ref_ptr, z_ptr, u_ptr, h_ptr, gamma, n,
                        BLOCK: tl.constexpr, INT64: tl.constexpr):
    pid = tl.program_id(0)
    if INT64:
        pid = pid.to(tl.int64)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    p = tl.load(p_ptr + offs, mask=mask).to(tl.float32)
    v = tl.load(v_ptr + offs, mask=mask).to(tl.float32)
    x_ref = tl.load(x_ref_ptr + offs, mask=mask).to(tl.float32)
    z = tl.load(z_ptr + offs, mask=mask).to(tl.float32)
    h = x_ref - (p - gamma * v)
    u = z + h
    tl.store(u_ptr + offs, u.to(u_ptr.dtype.element_ty), mask=mask)
    tl.store(h_ptr + offs, h.to(h_ptr.dtype.element_ty), mask=mask)


def _dse_combine_yh_kernel(p_ptr, v_ptr, x_ref_ptr, y_ptr, h_prev_ptr, u_ptr, h_ptr,
                           gamma, n, BLOCK: tl.constexpr, INT64: tl.constexpr):
    pid = tl.program_id(0)
    if INT64:
        pid = pid.to(tl.int64)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    p = tl.load(p_ptr + offs, mask=mask).to(tl.float32)
    v = tl.load(v_ptr + offs, mask=mask).to(tl.float32)
    x_ref = tl.load(x_ref_ptr + offs, mask=mask).to(tl.float32)
    y = tl.load(y_ptr + offs, mask=mask).to(tl.float32)
    h_prev = tl.load(h_prev_ptr + offs, mask=mask).to(tl.float32)
    h = x_ref - (p - gamma * v)
    u = y + h - h_prev
    tl.store(u_ptr + offs, u.to(u_ptr.dtype.element_ty), mask=mask)
    tl.store(h_ptr + offs, h.to(h_ptr.dtype.element_ty), mask=mask)


def launch_dse_combine(scalars, ins, outs) -> None:
    """ins (params, v, x_ref, z), outs (u, h)."""
    n = _triton.check_flat("dse_combine", ins, outs)
    (gamma,) = scalars
    _triton.jit(_dse_combine_kernel)[_triton.grid(n, BLOCK)](
        *ins, *outs, gamma, n,
        BLOCK=BLOCK, INT64=_triton.needs_int64(n, BLOCK), num_warps=4,
    )


def launch_dse_combine_yh(scalars, ins, outs) -> None:
    """ins (params, v, x_ref, y, h_prev), outs (u, h)."""
    n = _triton.check_flat("dse_combine_yh", ins, outs)
    (gamma,) = scalars
    _triton.jit(_dse_combine_yh_kernel)[_triton.grid(n, BLOCK)](
        *ins, *outs, gamma, n,
        BLOCK=BLOCK, INT64=_triton.needs_int64(n, BLOCK), num_warps=4,
    )
