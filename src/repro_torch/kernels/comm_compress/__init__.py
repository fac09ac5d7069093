from . import ops
from .kernel import (
    launch_qsgd_dequantize,
    launch_qsgd_quantize,
    launch_top_k_pack,
    launch_top_k_unpack,
)
from .ref import qsgd_dequantize_ref, qsgd_quantize_ref, top_k_pack_ref, top_k_unpack_ref

__all__ = [
    "ops", "launch_qsgd_quantize", "launch_qsgd_dequantize",
    "launch_top_k_pack", "launch_top_k_unpack",
    "qsgd_quantize_ref", "qsgd_dequantize_ref", "top_k_pack_ref", "top_k_unpack_ref",
]
