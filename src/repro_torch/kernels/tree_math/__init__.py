from . import ops
from .kernel import launch_axpby
from .ref import axpby_ref

__all__ = ["ops", "launch_axpby", "axpby_ref"]
