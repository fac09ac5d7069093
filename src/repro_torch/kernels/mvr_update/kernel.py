"""Triton kernel for the fused MVR direction update (Alg. 1 line 16).

Replaces the TPU kernel ``repro/kernels/mvr_update/kernel.py::mvr_update_expr``
as launched by ``repro/kernels/api.py::_flat_launch``:

    v_new = g_new + (1 - alpha) * (v - g_old)

Bound on the H100: HBM bytes.  3 reads + 1 write per element against 3 flops
(~0.2 flop/byte in fp32), far below the card's ~20 flop/byte fp32 ridge.
Design: one pass over the one flat buffer of a dtype bucket -- each program
streams a contiguous BLOCK with masked vector loads (the ragged tail is
masked, not padded), computes in fp32 and casts on store; alpha arrives as
an fp32 argument, so one compiled kernel serves every schedule step.
"""
from __future__ import annotations

from .. import _triton

__all__ = ["launch_mvr_update"]

BLOCK = 1024
tl = None   # triton.language, bound by _triton.jit on the first launch


def _mvr_update_kernel(g_new_ptr, v_ptr, g_old_ptr, out_ptr, alpha, n,
                       BLOCK: tl.constexpr, INT64: tl.constexpr):
    pid = tl.program_id(0)
    if INT64:
        pid = pid.to(tl.int64)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    g_new = tl.load(g_new_ptr + offs, mask=mask).to(tl.float32)
    v = tl.load(v_ptr + offs, mask=mask).to(tl.float32)
    g_old = tl.load(g_old_ptr + offs, mask=mask).to(tl.float32)
    out = g_new + (1.0 - alpha) * (v - g_old)
    tl.store(out_ptr + offs, out.to(out_ptr.dtype.element_ty), mask=mask)


def launch_mvr_update(scalars, ins, outs) -> None:
    """One launch over flat CUDA buffers: ins (g_new, v, g_old), outs (v_new,)."""
    n = _triton.check_flat("mvr_update", ins, outs)
    (alpha,) = scalars
    _triton.jit(_mvr_update_kernel)[_triton.grid(n, BLOCK)](
        *ins, *outs, alpha, n,
        BLOCK=BLOCK, INT64=_triton.needs_int64(n, BLOCK), num_warps=4,
    )
