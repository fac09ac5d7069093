"""Registry entries for the codecs' ops.

The QSGD codec calls the quantize / dequantize ops, and the top-k and
rand-k codecs the pack / unpack ops, through ``api.call`` on every
compressed gossip message, whatever the algorithm's ``use_fused`` says."""
from __future__ import annotations

from .. import api
from .kernel import (
    launch_qsgd_dequantize,
    launch_qsgd_quantize,
    launch_top_k_pack,
    launch_top_k_unpack,
)
from .ref import qsgd_dequantize_ref, qsgd_quantize_ref, top_k_pack_ref, top_k_unpack_ref

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

api.register(
    api.FusedOp(
        name="top_k_pack",
        ref_fn=top_k_pack_ref,
        launch_shaped=launch_top_k_pack,
        n_inputs=2,            # x (N, d), idx (N, k)
        doc="gather the packed top-k payload vals[i,j] = x[i, idx[i,j]]",
    )
)

api.register(
    api.FusedOp(
        name="top_k_unpack",
        ref_fn=top_k_unpack_ref,
        launch_shaped=launch_top_k_unpack,
        n_inputs=2,            # idx (N, k), vals (N, k); static d
        doc="scatter the packed payload back to a dense (N, d) buffer",
    )
)
