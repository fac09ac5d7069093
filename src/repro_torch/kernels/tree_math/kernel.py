"""Triton kernels for the tree arithmetic: ``axpby`` and ``add_sub``.

Replace the TPU kernels ``repro/kernels/tree_math/kernel.py::axpby_expr``
and ``::add_sub_expr`` as launched by ``repro/kernels/api.py::_flat_launch``.

  * ``axpby``: a*x + b*y.  On the DSE path it is the x step, the SPA
    subtraction and the z refresh; the baselines' SGD, momentum and
    slow-momentum steps use it too.
  * ``add_sub``: a + b - c, the gradient-tracking correction of GT-DSGD
    (``mix(y) + g_new - g_prev``) and GT-HSGD (``mix(y) + v_new - v``).

Bound on the H100: HBM bytes.  axpby moves 2 reads + 1 write per element
against 3 flops, add_sub 3 reads + 1 write against 2 flops (at most 0.25
flop/byte in fp32).  Design: one pass over the one flat buffer of a dtype
bucket; masked contiguous vector loads, fp32 compute, cast on store into
the output's dtype (axpby: y's, or the caller's ``like=``; add_sub: a's);
a and b arrive as fp32 arguments.
"""
from __future__ import annotations

from .. import _triton

__all__ = ["launch_axpby", "launch_add_sub"]

BLOCK = 1024
tl = None   # triton.language, bound by _triton.jit on the first launch


def _axpby_kernel(x_ptr, y_ptr, out_ptr, a, b, n,
                  BLOCK: tl.constexpr, INT64: tl.constexpr):
    pid = tl.program_id(0)
    if INT64:
        pid = pid.to(tl.int64)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    x = tl.load(x_ptr + offs, mask=mask).to(tl.float32)
    y = tl.load(y_ptr + offs, mask=mask).to(tl.float32)
    out = a * x + b * y
    tl.store(out_ptr + offs, out.to(out_ptr.dtype.element_ty), mask=mask)


def _add_sub_kernel(a_ptr, b_ptr, c_ptr, out_ptr, n,
                    BLOCK: tl.constexpr, INT64: tl.constexpr):
    pid = tl.program_id(0)
    if INT64:
        pid = pid.to(tl.int64)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    a = tl.load(a_ptr + offs, mask=mask).to(tl.float32)
    b = tl.load(b_ptr + offs, mask=mask).to(tl.float32)
    c = tl.load(c_ptr + offs, mask=mask).to(tl.float32)
    out = a + b - c
    tl.store(out_ptr + offs, out.to(out_ptr.dtype.element_ty), mask=mask)


def launch_axpby(scalars, ins, outs) -> None:
    """One launch over flat CUDA buffers: ins (x, y), outs (a*x + b*y,)."""
    n = _triton.check_flat("axpby", ins, outs)
    a, b = scalars
    _triton.jit(_axpby_kernel)[_triton.grid(n, BLOCK)](
        *ins, *outs, a, b, n,
        BLOCK=BLOCK, INT64=_triton.needs_int64(n, BLOCK), num_warps=4,
    )


def launch_add_sub(scalars, ins, outs) -> None:
    """One launch over flat CUDA buffers: ins (a, b, c), outs (a + b - c,)."""
    n = _triton.check_flat("add_sub", ins, outs)
    _triton.jit(_add_sub_kernel)[_triton.grid(n, BLOCK)](
        *ins, *outs, n,
        BLOCK=BLOCK, INT64=_triton.needs_int64(n, BLOCK), num_warps=4,
    )
