from . import ops
from .kernel import launch_wkv_chunk
from .ref import wkv_chunked_ref, wkv_grouped_ref, wkv_ref

__all__ = ["ops", "launch_wkv_chunk", "wkv_ref", "wkv_chunked_ref", "wkv_grouped_ref"]
