from . import ops
from .kernel import launch_dse_combine, launch_dse_combine_yh
from .ref import dse_combine_ref, dse_combine_yh_ref

__all__ = [
    "ops", "launch_dse_combine", "launch_dse_combine_yh",
    "dse_combine_ref", "dse_combine_yh_ref",
]
