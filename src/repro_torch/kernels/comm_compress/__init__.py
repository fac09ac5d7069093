from . import ops
from .kernel import launch_qsgd_dequantize, launch_qsgd_quantize
from .ref import qsgd_dequantize_ref, qsgd_quantize_ref

__all__ = [
    "ops", "launch_qsgd_quantize", "launch_qsgd_dequantize",
    "qsgd_quantize_ref", "qsgd_dequantize_ref",
]
