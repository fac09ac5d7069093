"""Message codecs: identity, qsgd, top_k, rand_k, low_rank.

Counterpart of ``repro.compression.compressors``.  Codecs work on
node-stacked leaves (leading axis N) and keep every payload tensor
node-stacked too.  The per-element hot paths run through the fused-op
registry (``repro_torch.kernels.comm_compress``): per leaf, one launch each
of QSGD's quantize and dequantize (Triton), or of the top-k / rand-k pack
and unpack (CUDA C++), on CUDA; the plain versions on the CPU.

Where the reference draws from a PRNG key (rand-k's index set, low-rank's
sketch), the port draws from a ``torch.Generator`` on the CPU seeded with
the leaf's seed, so every device gets the same draw; the draw is a field of
the codec, so parity tests inject the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..kernels import api as fused
from .base import Compressor, Packed, register_compressor

__all__ = ["Identity", "QSGD", "TopK", "RandK", "LowRank"]

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


@dataclasses.dataclass(frozen=True)
class TopK(Compressor):
    """Magnitude sparsification: keep the ``ceil(ratio * d)`` largest-|x|
    entries per node per leaf.  Payload = packed values + int32 indices.
    Biased: use under :class:`~.base.ErrorFeedback` (the ``make_compressor``
    default)."""

    ratio: float = 0.1

    def __post_init__(self):
        if not 0.0 < float(self.ratio) <= 1.0:
            raise ValueError(f"top_k ratio must be in (0, 1], got {self.ratio}")

    @property
    def tag(self) -> str:
        return f"top_k{self.ratio:g}"

    def k_for(self, d: int) -> int:
        return max(1, min(d, int(math.ceil(float(self.ratio) * d))))

    def _indices(self, flat: torch.Tensor, seed: int, k: int) -> torch.Tensor:
        # a stable sort, as the reference's argsort: descending |x|, ties to
        # the lower index.  torch.topk picks the same set in another order,
        # and the order is the payload's layout (the scale path keeps its
        # first slots)
        order = torch.sort(-flat.float().abs(), dim=1, stable=True).indices
        return order[:, :k].to(torch.int32).contiguous()

    def encode(self, x, seed, scale=None):
        flat, shape = _flat(x)
        flat = flat.contiguous()
        d = flat.shape[1]
        k = self.k_for(d)
        idx = self._indices(flat, seed, k)
        vals = fused.call("top_k_pack", flat, idx)
        if scale is not None:
            # adaptive ratio: keep the first ceil(scale * k) slots (the
            # largest magnitudes) and zero the rest; the payload keeps its shape
            k_eff = min(max(math.ceil(np.float32(k) * np.float32(scale)), 1), k)
            keep = torch.arange(k, device=x.device)[None, :] < k_eff
            vals = torch.where(keep, vals, torch.zeros((), dtype=vals.dtype, device=x.device))
        return Packed({"idx": idx, "vals": vals}, meta=(shape, x.dtype, d))

    def decode(self, packed):
        shape, dtype, d = packed.meta
        idx, vals = packed.data["idx"], packed.data["vals"]
        dense = fused.call("top_k_unpack", idx, vals, d=d)
        return dense.reshape((idx.shape[0],) + shape).to(dtype)

    def payload_bytes(self, shape, dtype, scale=None):
        d = int(math.prod(shape))
        k = self.k_for(d)
        if scale is not None:
            k = max(1, min(k, int(math.ceil(k * float(scale)))))
        return k * (4 + dtype.itemsize)


def _randperm_draw(seed: int, d: int, k: int) -> torch.Tensor:
    """k distinct indices of [0, d), from a CPU generator seeded with ``seed``."""
    return torch.randperm(d, generator=torch.Generator().manual_seed(int(seed)))[:k]


@dataclasses.dataclass(frozen=True)
class RandK(TopK):
    """Random-k sparsification: one fresh index set per leaf and event, shared
    by all nodes, in top-k's packed payload.

    ``index_draw(seed, d, k)`` returns the k distinct indices (the
    reference's ``jax.random.choice(key, d, (k,), replace=False)``); by
    default a seeded ``randperm`` on the CPU."""

    ratio: float = 0.1
    index_draw: Optional[Callable[[int, int, int], torch.Tensor]] = None

    @property
    def tag(self) -> str:
        return f"rand_k{self.ratio:g}"

    def _indices(self, flat, seed, k):
        draw = self.index_draw or _randperm_draw
        idx = torch.as_tensor(draw(seed, flat.shape[1], k))
        idx = idx.to(device=flat.device, dtype=torch.int32)
        return idx[None].expand(flat.shape[0], k).contiguous()


def _normal_draw(seed: int, rows: int, cols: int) -> torch.Tensor:
    """A (rows, cols) standard normal fp32 sketch from a seeded CPU generator."""
    return torch.randn((rows, cols), generator=torch.Generator().manual_seed(int(seed)))


@dataclasses.dataclass(frozen=True)
class LowRank(Compressor):
    """PowerSGD-style rank-r factorization (Vogels et al. 2019): one power
    iteration ``P = orth(M Q0)``, ``Q = Mᵀ P`` against a seeded sketch
    ``Q0`` shared by all nodes; transmit the (m + n) * r factor pair.  Leaves
    without a matrix shape (biases), or where the factors would not be
    smaller, go raw.

    ``sketch_draw(seed, n, r)`` returns ``Q0`` (the reference's
    ``jax.random.normal(key, (n, r))``); by default a seeded ``randn`` on
    the CPU.  The signs of QR's columns differ between LAPACK, cuSOLVER and
    XLA; the decoded ``P Pᵀ M`` does not depend on them."""

    rank: int = 2
    sketch_draw: Optional[Callable[[int, int, int], torch.Tensor]] = None

    def __post_init__(self):
        if int(self.rank) < 1:
            raise ValueError(f"low_rank rank must be >= 1, got {self.rank}")

    @property
    def tag(self) -> str:
        return f"low_rank{self.rank}"

    def _plan(self, shape: Tuple[int, ...]):
        """(m, n, r) when factorizing wins for this per-node shape, else None."""
        if len(shape) < 2:
            return None
        m, nn = shape[0], int(math.prod(shape[1:]))
        r = min(int(self.rank), m, nn)
        if r < 1 or (m + nn) * r >= m * nn:
            return None
        return m, nn, r

    def encode(self, x, seed, scale=None):
        del scale  # rank is structural; no per-round knob for this codec
        flat_shape = tuple(x.shape[1:])
        plan = self._plan(flat_shape)
        if plan is None:
            return Packed({"raw": x}, meta=(flat_shape, x.dtype, None))
        m, nn, r = plan
        mat = x.reshape(x.shape[0], m, nn).float()
        draw = self.sketch_draw or _normal_draw
        q0 = torch.as_tensor(draw(seed, nn, r)).to(device=x.device, dtype=torch.float32)
        p = torch.linalg.qr(mat @ q0).Q                 # (N, m, r), orthonormal
        q = torch.einsum("nmc,nmr->ncr", mat, p)        # (N, nn, r)
        return Packed({"p": p, "q": q}, meta=(flat_shape, x.dtype, plan))

    def decode(self, packed):
        shape, dtype, plan = packed.meta
        if plan is None:
            return packed.data["raw"]
        p, q = packed.data["p"], packed.data["q"]
        mat = torch.einsum("nmr,ncr->nmc", p, q)
        return mat.reshape((p.shape[0],) + shape).to(dtype)

    def payload_bytes(self, shape, dtype, scale=None):
        del scale
        plan = self._plan(tuple(shape))
        if plan is None:
            return int(math.prod(shape)) * dtype.itemsize
        m, nn, r = plan
        return (m + nn) * r * 4


# --------------------------------------------------------------------------
# registry entries (``make_compressor`` shorthands: "top_k:0.05", "qsgd:63",
# "rand_k:0.25", "low_rank:4")
# --------------------------------------------------------------------------
def _identity(arg=None, **kw):
    del arg
    return Identity(**kw)


def _qsgd(arg=None, **kw):
    if arg is not None:
        kw.setdefault("levels", int(arg))
    return QSGD(**kw)


def _top_k(arg=None, **kw):
    if arg is not None:
        kw.setdefault("ratio", float(arg))
    return TopK(**kw)


def _rand_k(arg=None, **kw):
    if arg is not None:
        kw.setdefault("ratio", float(arg))
    return RandK(**kw)


def _low_rank(arg=None, **kw):
    if arg is not None:
        kw.setdefault("rank", int(arg))
    return LowRank(**kw)


register_compressor("identity", _identity)
register_compressor("qsgd", _qsgd)
register_compressor("top_k", _top_k)
register_compressor("rand_k", _rand_k)
register_compressor("low_rank", _low_rank)
