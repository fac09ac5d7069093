from . import ops
from .kernel import launch_mvr_update
from .ref import mvr_update_ref

__all__ = ["ops", "launch_mvr_update", "mvr_update_ref"]
