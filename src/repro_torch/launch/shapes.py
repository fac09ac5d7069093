"""The four assigned input shapes and the per-architecture applicability
matrix (skips recorded per the assignment rules; see DESIGN.md §4).

A copy of ``repro.launch.shapes`` (standard library only)."""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["InputShape", "SHAPES", "shape_applicability"]


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

# sub-quadratic decode support: SSM / hybrid / sliding-window archs
LONG_CONTEXT_OK = {"rwkv6-3b", "zamba2-7b", "gemma2-2b"}
ENCODER_ONLY = {"hubert-xlarge"}


def shape_applicability(arch_name: str, shape: str) -> Optional[str]:
    """None if the (arch, shape) pair runs; else the documented skip reason."""
    base = arch_name.replace("_", "-").replace("-reduced", "")
    if shape in ("decode_32k", "long_500k") and base in ENCODER_ONLY:
        return "encoder-only architecture: no autoregressive decode step"
    if shape == "long_500k" and base not in LONG_CONTEXT_OK:
        return (
            "pure full-attention architecture: 512k decode requires the "
            "sub-quadratic (SSM / sliding-window) cache path (DESIGN.md §4)"
        )
    return None
