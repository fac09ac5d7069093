"""Registry entry for the chunked wkv recurrence.

``api.call("wkv_chunk", r, k, v, logw, chunk=...)`` in the model's
(B, S, H, P) layout, as ``repro.kernels.wkv_chunk.ops`` registers it.  The
plain version is the exact per-token recurrence ``wkv_ref`` (it ignores
``chunk``, as the reference's does); the kernel computes the clamped
chunked form, so the two agree only where no chunk's log-decay sums past
-25 (``ref.py``).  As in the reference, the op's backward is its plain
version's gradient, that of the unclamped recurrence (``api.call``'s
autograd Function).
"""
from __future__ import annotations

from .. import api
from .kernel import launch_wkv_chunk
from .ref import wkv_ref


def _wkv_kernel_call(r, k, v, logw, chunk=16):
    return launch_wkv_chunk(r.contiguous(), k.contiguous(), v.contiguous(), logw.contiguous(),
                            chunk=chunk)


def _wkv_ref_call(r, k, v, logw, chunk=16):
    del chunk   # the per-token recurrence has no chunking
    return wkv_ref(r, k, v, logw)


api.register(
    api.FusedOp(
        name="wkv_chunk",
        ref_fn=_wkv_ref_call,
        launch_shaped=_wkv_kernel_call,
        n_inputs=4,
        n_outputs=2,   # (y, s_final)
        doc="RWKV-6 recurrence, chunked, (B, S, H, P) layout (the prefill's time-mix)",
    )
)
