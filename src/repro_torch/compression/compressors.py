"""Message codecs: identity and QSGD.

Counterpart of ``repro.compression.compressors``.  Codecs work on
node-stacked leaves (leading axis N) and keep every payload tensor
node-stacked too.  QSGD's per-element hot paths run through the fused-op
registry (``repro_torch.kernels.comm_compress``): one Triton launch per leaf
for the quantize and one for the dequantize on CUDA, the plain version on
the CPU.

``top_k``, ``rand_k`` and ``low_rank`` are registered names that check their
``:arg`` as the reference does and then raise ``NotImplementedError``: they
come with the top-k kernels (ROADMAP queue 1 item 5).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..kernels import api as fused
from .base import NOT_PORTED, Compressor, Packed, register_compressor

__all__ = ["Identity", "QSGD"]

_M32 = 0xFFFFFFFF


def _flat(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """(N, d) view of a node-stacked leaf + its per-node shape."""
    return x.reshape(x.shape[0], -1), tuple(x.shape[1:])


def _hash_uniform(seed: int, shape: Tuple[int, int], device=None) -> torch.Tensor:
    """Counter-based Uniform[0, 1) noise, bit for bit the reference's: a
    murmur3 finalizer of ``row * d + col + seed`` in uint32 arithmetic.

    ``seed`` is the reference's ``key_data[0] ^ key_data[-1]``.  torch has no
    usable uint32, so the hash runs in int64 and keeps the low 32 bits after
    every multiply, add and xor; they survive int64 wraparound."""
    n, d = shape
    rows = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(d, dtype=torch.int64, device=device)[None, :]
    z = ((rows * d) & _M32) + cols
    z = (z + (int(seed) & _M32)) & _M32
    z = (z * 0x9E3779B9) & _M32
    z = z ^ (z >> 16)
    z = (z * 0x85EBCA6B) & _M32
    z = z ^ (z >> 13)
    z = (z * 0xC2B2AE35) & _M32
    z = z ^ (z >> 16)
    return (z >> 8).to(torch.float32) * (1.0 / (1 << 24))


@dataclasses.dataclass(frozen=True)
class Identity(Compressor):
    """The no-op codec.  The round executor short-circuits it to the exact
    uncompressed gossip path; encode/decode serve codec-level use only."""

    is_identity = True

    def encode(self, x, seed, scale=None):
        del seed, scale
        return Packed({"raw": x})

    def decode(self, packed):
        return packed.data["raw"]

    def payload_bytes(self, shape, dtype, scale=None):
        del scale
        return int(math.prod(shape)) * dtype.itemsize


@dataclasses.dataclass(frozen=True)
class QSGD(Compressor):
    """Stochastic uniform quantization to one signed byte per element
    (Alistarh et al. 2017): per-node scale ``s = max|x|``, ``L <= 127``
    levels, transmit ``q = sign(x) * floor(|x|/s * L + u)`` as int8 plus the
    fp32 scale; unbiased thanks to the uniform noise ``u``."""

    levels: int = 127

    def __post_init__(self):
        if not 1 <= int(self.levels) <= 127:
            raise ValueError(f"qsgd levels must be in [1, 127], got {self.levels}")

    def encode(self, x, seed, scale=None):
        flat, shape = _flat(x)
        s = flat.float().abs().amax(dim=1)
        safe = torch.where(s > 0, s, torch.ones_like(s))
        xn = flat.float() / safe[:, None]
        u = _hash_uniform(seed, tuple(flat.shape), device=x.device)
        meta = (shape, x.dtype)
        if scale is None:
            qf = fused.call("qsgd_quantize", xn, u, scalars=(float(self.levels),))
            return Packed({"q": qf.to(torch.int8), "scale": s}, meta=meta)
        # adaptive levels: the schedule scales the level count, which then
        # travels in the payload; plain tensor code, as in the reference
        lv = torch.clamp(
            torch.round(torch.tensor(float(self.levels), device=x.device) * scale),
            1.0, float(self.levels),
        )
        qf = torch.clamp(torch.sign(xn) * torch.floor(xn.abs() * lv + u), -127.0, 127.0)
        return Packed(
            {"q": qf.to(torch.int8), "scale": s, "lv": lv.expand(flat.shape[0])},
            meta=meta,
        )

    def decode(self, packed):
        shape, dtype = packed.meta
        q, scale = packed.data["q"], packed.data["scale"]
        if "lv" in packed.data:
            deq = q.float() * (scale / packed.data["lv"])[:, None]
        else:
            # the broadcast scale is materialised by tree_apply's flatten,
            # as the reference's broadcast-then-ravel does
            deq = fused.call(
                "qsgd_dequantize", q, scale[:, None].expand(q.shape),
                scalars=(1.0 / float(self.levels),),
            )
        return deq.reshape((q.shape[0],) + shape).to(dtype)

    def payload_bytes(self, shape, dtype, scale=None):
        del dtype  # 1 byte/element + the fp32 scale
        d = int(math.prod(shape))
        if scale is None:
            return d * 1 + 4
        lv = max(1, min(int(self.levels), round(self.levels * float(scale))))
        bits = math.ceil(math.log2(2 * lv + 1))
        return math.ceil(d * min(bits, 8) / 8) + 4


# --------------------------------------------------------------------------
# registry entries (``make_compressor`` shorthands: "qsgd:63")
# --------------------------------------------------------------------------
def _identity(arg=None, **kw):
    del arg
    return Identity(**kw)


def _qsgd(arg=None, **kw):
    if arg is not None:
        kw.setdefault("levels", int(arg))
    return QSGD(**kw)


def _unported(name: str, field: str, parse, valid):
    """A registered codec that is not ported: its ``:arg`` and keyword are
    checked as the reference checks them (``ValueError``), then it raises."""

    def factory(arg=None, **kw):
        if arg is not None:
            kw.setdefault(field, parse(arg))
        if field in kw and not valid(kw[field]):
            raise ValueError(f"{name} {field} out of range: {kw[field]!r}")
        raise NotImplementedError(f"the {name} codec {NOT_PORTED}")

    return factory


register_compressor("identity", _identity)
register_compressor("qsgd", _qsgd)
register_compressor("top_k", _unported("top_k", "ratio", float, lambda r: 0.0 < r <= 1.0))
register_compressor("rand_k", _unported("rand_k", "ratio", float, lambda r: 0.0 < r <= 1.0))
register_compressor("low_rank", _unported("low_rank", "rank", int, lambda r: r >= 1))
