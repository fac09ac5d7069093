from . import ops
from .kernel import launch_rms_norm
from .ref import rms_norm_ref

__all__ = ["ops", "launch_rms_norm", "rms_norm_ref"]
