"""Registry entries for the QSGD quantize / dequantize ops.

The QSGD codec (``repro_torch.compression.compressors.QSGD``) calls them
through ``api.call`` on every compressed gossip message, whatever the
algorithm's ``use_fused`` says.  The top-k pack / unpack ops are not ported
yet (ROADMAP queue 2 item 6)."""
from __future__ import annotations

from .. import api
from .kernel import launch_qsgd_dequantize, launch_qsgd_quantize
from .ref import qsgd_dequantize_ref, qsgd_quantize_ref

api.register(
    api.FusedOp(
        name="qsgd_quantize",
        ref_fn=qsgd_quantize_ref,
        launch=launch_qsgd_quantize,
        n_inputs=2,            # normalized x, uniform noise
        n_outputs=1,
        n_scalars=1,           # levels
        out_dtype_from=(0,),
        doc="stochastic quantization of a normalized buffer to signed levels",
    )
)

api.register(
    api.FusedOp(
        name="qsgd_dequantize",
        ref_fn=qsgd_dequantize_ref,
        launch=launch_qsgd_dequantize,
        n_inputs=2,            # q (int8 payload, upcast in-kernel), scale bcast
        n_outputs=1,
        n_scalars=1,           # 1/levels
        out_dtype_from=(1,),   # the scale's dtype, NOT the int8 payload's
        doc="dequantize q * scale / levels",
    )
)
