from . import ops
from .kernel import launch_add_sub, launch_axpby
from .ref import add_sub_ref, axpby_ref

__all__ = ["ops", "launch_axpby", "launch_add_sub", "axpby_ref", "add_sub_ref"]
