"""Build-on-first-launch support for the port's CUDA C++ kernels.

Each ``.cu`` source under ``repro_torch/csrc/`` exports plain C entry points
that take raw device pointers, sizes and a stream, launch their kernels and
return the ``cudaGetLastError()`` of the launch.  :func:`library` compiles a
source with ``nvcc`` for ``sm_90a`` into a shared library under the
checkout's ``build/cuda/`` (listed in ``.gitignore``) and loads it with
``ctypes``.  The library's file name carries a hash of the source and the
flags, so an edited source never loads a stale build.

Nothing is compiled or loaded until a kernel is launched (or :func:`build`
is called), so every module imports on a machine without ``nvcc`` or a
card; there the first launch raises ``RuntimeError``.  :func:`build` starts
one ``nvcc`` per source at once and waits for all of them, so a program that
needs several libraries pays for the slowest build, not the sum.  The
compiler's ``-Xptxas -v`` report (registers, shared memory and spills per
kernel) is kept beside each library as ``.log`` (:func:`build_log`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

__all__ = ["NVCC_FLAGS", "find_nvcc", "build", "build_log", "library", "check", "stream_of",
           "check_tensors"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# the build goes under the checkout's build/ (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "cuda"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
DEFAULT_CUDA_HOME = "/usr/local/cuda"
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``, then
    ``PATH``; raises ``RuntimeError`` naming what is missing."""
    tried = []
    home = os.environ.get("CUDA_HOME")
    for root in ([home] if home else []) + [DEFAULT_CUDA_HOME]:
        cand = Path(root) / "bin" / "nvcc"
        tried.append(str(cand))
        if cand.is_file() and os.access(cand, os.X_OK):
            return str(cand)
    on_path = shutil.which("nvcc")
    if on_path:
        return on_path
    raise RuntimeError(
        "the port's CUDA C++ kernels are compiled on first launch, and no nvcc "
        f"was found (tried {', '.join(tried)} and PATH); install the CUDA "
        "toolkit or set CUDA_HOME"
    )


def _target(name: str) -> Path:
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Compile ``csrc/<name>.cu`` for each name not built yet, one ``nvcc``
    per source, all started together; returns each library's path."""
    outs = {name: _target(name) for name in names}
    todo = {name: out for name, out in outs.items() if not out.exists()}
    if not todo:
        return outs
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    try:
        for name, out in todo.items():
            # compile beside the target and rename, so a concurrent process
            # never loads a half-written library; the compiler's report goes
            # to a file, so no pipe fills while another build is awaited
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            with open(tmp + ".log", "w") as log:
                proc = subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                    stdout=log, stderr=subprocess.STDOUT)
            running.append((name, out, tmp, proc))
        failed = []
        for name, out, tmp, proc in running:
            proc.wait()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {name}.cu:\n{Path(tmp + '.log').read_text()}")
                continue
            os.replace(tmp + ".log", out.with_suffix(".log"))
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, _, tmp, proc in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            for path in (tmp, tmp + ".log"):
                if os.path.exists(path):
                    os.unlink(path)
    return outs


def build_log(name: str) -> str:
    """The ``-Xptxas -v`` report of the built ``csrc/<name>.cu``."""
    return _target(name).with_suffix(".log").read_text()


def library(name: str, functions: Dict[str, Sequence]) -> ctypes.CDLL:
    """The compiled ``csrc/<name>.cu`` as a loaded library, built on the
    first call.  ``functions`` maps each entry point to its ``argtypes``
    (``c_void_p`` for every pointer and the stream); each returns a
    ``cudaError_t`` as ``int``.  Every source also exports
    ``<name>_error_string``, which wraps ``cudaGetErrorString``."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        for fn, argtypes in functions.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        errstr = getattr(lib, f"{name}_error_string")
        errstr.argtypes = [ctypes.c_int]
        errstr.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(name: str, what: str, err: int) -> None:
    """Raise when a launch from library ``name`` reported a CUDA error."""
    if err != 0:
        msg = getattr(_loaded[name], f"{name}_error_string")(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} at launch: {msg}")


def stream_of(t: torch.Tensor) -> int:
    """The current stream of ``t``'s device, as a raw handle (the call
    Triton's launcher makes: a microsecond less than building a
    ``torch.cuda.Stream``)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check_tensors(name: str, tensors: Tuple[Tuple[str, torch.Tensor, tuple, Optional[tuple]], ...]):
    """Validate ``(label, tensor, dtypes, shape)`` for one launch: one CUDA
    device, contiguous, a dtype in ``dtypes`` and, where given, the shape."""
    dev = tensors[0][1].device
    for label, t, dtypes, shape in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: every tensor must be on one CUDA device")
        if t.dtype not in dtypes:
            raise ValueError(f"{name}: unsupported {label} dtype {t.dtype}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
