from . import ops
from .kernel import launch_flash_attention
from .ref import flash_attention_ref

__all__ = ["ops", "launch_flash_attention", "flash_attention_ref"]
