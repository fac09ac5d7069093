"""Hand-written Hopper kernels behind one fused-op backend (``api``).

Each package keeps kernel.py (the Triton kernel and its launcher), ref.py
(the plain PyTorch version: the CPU path and the yardstick the kernel is
held to) and ops.py (the :class:`~repro_torch.kernels.api.FusedOp`
registration).  Importing this package populates the registry with the four
ops of the DSE path: mvr_update, axpby, dse_combine, dse_combine_yh.
"""
from . import api
from . import dse_combine, mvr_update, tree_math
from .api import (
    REGISTRY,
    FusedOp,
    call_counts,
    dispatch_mode,
    launch_counts,
    register,
    reset_counters,
    tree_apply,
    tree_axpby,
    tree_dse_combine,
    tree_dse_combine_yh,
    tree_mvr_update,
)

__all__ = [
    "api", "mvr_update", "tree_math", "dse_combine",
    "FusedOp", "REGISTRY", "register", "tree_apply", "dispatch_mode",
    "tree_mvr_update", "tree_axpby", "tree_dse_combine", "tree_dse_combine_yh",
    "launch_counts", "call_counts", "reset_counters",
]
