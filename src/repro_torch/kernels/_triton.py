"""Compile-on-first-launch support shared by the port's Triton kernels.

Each ``kernel.py`` writes its Triton body as a plain module-level function
that names ``tl`` as a module global (bound to ``triton.language`` here) and
annotates its block size as ``tl.constexpr`` (a string, under
``from __future__ import annotations``).  Nothing imports ``triton`` until a
kernel is launched, so every module imports on a machine without it; there
a launch raises ``ImportError`` instead of running anything else.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, Dict

import torch

__all__ = ["jit", "check_flat", "grid", "needs_int64"]

# the JIT cache goes under the checkout's build/ (listed in .gitignore)
_CACHE_DIR = Path(__file__).resolve().parents[3] / "build" / "triton"
_compiled: Dict[Callable, Callable] = {}
_INT32_MAX = 2**31 - 1


def jit(body: Callable) -> Callable:
    """``triton.jit(body)``, built on the first call and cached."""
    kernel = _compiled.get(body)
    if kernel is None:
        os.environ.setdefault("TRITON_CACHE_DIR", str(_CACHE_DIR))
        import triton
        import triton.language as tl

        body.__globals__["tl"] = tl
        kernel = _compiled[body] = triton.jit(body)
    return kernel


_FLOATS = (torch.float32, torch.bfloat16, torch.float16)


def check_flat(name: str, ins, outs) -> int:
    """Validate the flat buffers of one launch; returns their length.

    Inputs may also be int8 (the QSGD payload, upcast in registers);
    outputs are floating point."""
    n = ins[0].numel()
    dev = ins[0].device
    for b in tuple(ins) + tuple(outs):
        if b.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: every buffer must be on one CUDA device")
        if b.dim() != 1 or b.numel() != n or not b.is_contiguous():
            raise ValueError(f"{name}: buffers must be contiguous 1-D of length {n}")
    for b in ins:
        if b.dtype not in _FLOATS + (torch.int8,):
            raise ValueError(f"{name}: unsupported input dtype {b.dtype}")
    for b in outs:
        if b.dtype not in _FLOATS:
            raise ValueError(f"{name}: unsupported output dtype {b.dtype}")
    return n


def grid(n: int, block: int):
    return (-(-n // block),)


def needs_int64(n: int, block: int) -> bool:
    """Offsets past int32 need 64-bit arithmetic (the last block overhangs n)."""
    return n + block > _INT32_MAX
