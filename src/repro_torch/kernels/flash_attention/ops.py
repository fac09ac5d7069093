"""Registry entry for the flash-attention forward.

``api.call("flash_attention", q, k, v, causal=..., sliding_window=...,
softcap=...)`` in the model's (B, S, H, D) layout, as
``repro.kernels.flash_attention.ops`` registers it.  The reference's
launcher transposes to the TPU kernel's (B, H, S, D); the port's kernel
reads (B, S, H, D) in place, so the adapter here only makes the tensors
contiguous (the projections' outputs already are).  As in the reference,
the op's backward is its plain version's gradient (``api.call``'s autograd
Function): training runs the kernel forward and no backward kernel.
"""
from __future__ import annotations

from .. import api
from .kernel import launch_flash_attention
from .ref import flash_attention_ref



def _flash_kernel_call(q, k, v, causal=True, sliding_window=None, softcap=None):
    return launch_flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                  causal=causal, sliding_window=sliding_window,
                                  softcap=softcap)


api.register(
    api.FusedOp(
        name="flash_attention",
        ref_fn=flash_attention_ref,
        launch_shaped=_flash_kernel_call,
        n_inputs=3,
        doc="online-softmax attention, (B, S, H, D) layout, GQA/window/softcap",
    )
)
