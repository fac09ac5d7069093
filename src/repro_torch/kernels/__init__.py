"""Hand-written Hopper kernels behind one fused-op backend (``api``).

Each package keeps kernel.py (the kernel's launcher: a Triton body, or a
``ctypes`` wrapper of a CUDA C++ source in ``repro_torch/csrc/``), ref.py
(the plain PyTorch version: the CPU path and the yardstick the kernel is
held to) and ops.py (the :class:`~repro_torch.kernels.api.FusedOp`
registration).  Importing this package populates the registry with twelve
ops: mvr_update, axpby, add_sub, dse_combine, dse_combine_yh (the update
arithmetic, Triton), qsgd_quantize, qsgd_dequantize (the QSGD codec,
Triton), top_k_pack, top_k_unpack (the top-k and rand-k codecs' packed
payload, CUDA C++), flash_attention (the LM prefill's attention, CUDA C++),
rms_norm (CUDA C++; registered, called by no model, as in the reference) and
wkv_chunk (RWKV-6's chunked time-mix recurrence in prefill, CUDA C++).
"""
from . import api
from . import (comm_compress, dse_combine, flash_attention, mvr_update, rms_norm, tree_math,
               wkv_chunk)
from .api import (
    REGISTRY,
    FusedOp,
    call,
    call_counts,
    dispatch_mode,
    launch_counts,
    register,
    reset_counters,
    tree_add_sub,
    tree_apply,
    tree_axpby,
    tree_dse_combine,
    tree_dse_combine_yh,
    tree_mvr_update,
)

__all__ = [
    "api", "mvr_update", "tree_math", "dse_combine", "comm_compress",
    "flash_attention", "rms_norm", "wkv_chunk",
    "FusedOp", "REGISTRY", "register", "tree_apply", "call", "dispatch_mode",
    "tree_mvr_update", "tree_axpby", "tree_add_sub",
    "tree_dse_combine", "tree_dse_combine_yh",
    "launch_counts", "call_counts", "reset_counters",
]
