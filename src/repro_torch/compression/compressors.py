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

QSGD's noise is a hash of the element's global position, row by node.  A
rank of the sharded engine encodes only its own nodes, so its codec numbers
their rows from its first global node (``QSGD.row0``, bound by
:meth:`~.base.Compressor.at_rows`), which gives every node the noise it
draws on one rank and in the reference, whose hash runs over the global
iota.  Rand-k's and low-rank's draws are one per leaf, shared by all nodes,
and need no offset.

On a node spread over several ranks each codec also encodes a leaf's shard
(``encode_shard``, bound by :class:`~.base.AtShard`) to its part of the whole
leaf's message, bit for bit (low-rank: up to its partial sums' order).  A
shard lies over one group along one dim, or under the '2d' layout over the
model group along one dim and the data group along another
(:class:`~.base.Shard`); its collectives run over the model group first:

  * QSGD: the scale is the max of the shards' maxima over the shard's
    groups; the noise hashes each element's index in the whole leaf's (N,
    d) flattening (for a shard on a later dim, or on two dims, a strided
    index); the levels of the shard are this rank's, the scale every
    rank's;
  * top-k: each rank takes its shard's best ``min(k, d_shard)``
    candidates (the pack kernel at the shard's shape) with their whole-leaf
    indices; the shard's groups gather them and every rank merges them in
    the whole leaf's stable order (descending |x|, ties to the lower
    index): the whole payload, on every rank; decoding unpacks the entries
    in this shard, re-indexed, the others padded as +0.0 adds;
  * rand-k: the whole leaf's index draw on every rank; each rank packs the
    entries in its shard and each slot takes its value from its owner;
  * low-rank: ``_plan`` and the sketch of the whole leaf on the matrix view
    (rows = the leaf's dim 0, columns = the rest).  ``M Q0``'s partial
    products are summed over the groups that split the columns and its
    row blocks concatenated over the group that splits the rows, QR runs
    on the replicated product, and ``Mᵀ P``'s partial products are summed
    over the row group.  A rank keeps its rows of P where the rows are
    split and its rows of Q (its columns of M) where the columns are: the
    factor of an unsplit side is the whole node's (``shared``), and where
    a leaf is split on both sides (an expert's rows over one group, its
    columns over the other) neither is.

The int64 work of the noise hash and of top-k's stable sort runs a slice
at a time (a chunk of elements, a node row), so that its temporaries stay
O(d) next to a node-stacked leaf: a full-width tied embedding is 233 M
elements a node.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..kernels import api as fused
from .base import Compressor, Packed, Shard, _to_global, register_compressor

__all__ = ["Identity", "QSGD", "TopK", "RandK", "LowRank"]

_M32 = 0xFFFFFFFF
_HASH_CHUNK = 1 << 25   # elements hashed at a time


def _flat(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """(N, d) view of a node-stacked leaf + its per-node shape."""
    return x.reshape(x.shape[0], -1), tuple(x.shape[1:])


def _hash_uniform(seed: int, shape: Tuple[int, int], row0: int = 0,
                  device=None, shard: Optional[Shard] = None) -> torch.Tensor:
    """Counter-based Uniform[0, 1) noise, bit for bit the reference's: a
    murmur3 finalizer of ``row * d + col + seed`` in uint32 arithmetic,
    ``row`` counted from global node ``row0``; with a ``shard``, ``shape``
    is the shard's (N, d_shard) and ``col`` each element's index in the
    whole leaf's d.

    ``seed`` is the reference's ``key_data[0] ^ key_data[-1]``.  torch has no
    usable uint32, so the hash runs in int64 and keeps the low 32 bits after
    every multiply, add and xor; they survive int64 wraparound.  It runs
    :data:`_HASH_CHUNK` elements at a time, in place, into the fp32 result,
    so that its int64 buffers stay that size whatever the leaf's."""
    n, d = shape
    out = torch.empty((n, d), dtype=torch.float32, device=device)
    flat = out.view(-1)
    whole = d if shard is None else shard.d
    # (row0 + r) * d + c + seed == row0 * d + seed + (the element's flat index)
    base = (int(row0) * whole + int(seed)) & _M32
    for a in range(0, n * d, _HASH_CHUNK):
        b = min(n * d, a + _HASH_CHUNK)
        z = torch.arange(a, b, dtype=torch.int64, device=device)
        if shard is not None:
            # row r, shard column l -> r * whole + (l's whole-leaf column)
            r = z // d
            z = shard.to_global(z.sub_(r * d)).add_(r.mul_(whole))
            del r
        z.add_(base).bitwise_and_(_M32)
        z.mul_(0x9E3779B9).bitwise_and_(_M32)
        z.bitwise_xor_(z >> 16)
        z.mul_(0x85EBCA6B).bitwise_and_(_M32)
        z.bitwise_xor_(z >> 13)
        z.mul_(0xC2B2AE35).bitwise_and_(_M32)
        z.bitwise_xor_(z >> 16)
        flat[a:b].copy_(z.bitwise_right_shift_(8)).mul_(1.0 / (1 << 24))
    return out


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

    def encode_shard(self, x, seed, shard, scale=None):
        return self.encode(x, seed, scale)

    def decode_shard(self, packed, shard):
        return self.decode(packed)

    def whole_payload(self, packed, shard):
        return Packed({"raw": shard.gather(packed.data["raw"])})


@dataclasses.dataclass(frozen=True)
class QSGD(Compressor):
    """Stochastic uniform quantization to one signed byte per element
    (Alistarh et al. 2017): per-node scale ``s = max|x|``, ``L <= 127``
    levels, transmit ``q = sign(x) * floor(|x|/s * L + u)`` as int8 plus the
    fp32 scale; unbiased thanks to the uniform noise ``u``.  ``row0`` is
    the global node of the leaves' row 0, which numbers the noise (the
    sharded engine's rank binds its first node, :meth:`at_rows`)."""

    levels: int = 127
    row0: int = 0

    def __post_init__(self):
        if not 1 <= int(self.levels) <= 127:
            raise ValueError(f"qsgd levels must be in [1, 127], got {self.levels}")

    def at_rows(self, row0):
        return self if int(row0) == self.row0 else dataclasses.replace(self, row0=int(row0))

    def encode(self, x, seed, scale=None, shard: Optional[Shard] = None):
        flat, shape = _flat(x)
        s = flat.float().abs().amax(dim=1)
        if shard is not None:
            s = shard.group.all_reduce(s, op="max", key="codec")
        safe = torch.where(s > 0, s, torch.ones_like(s))
        xn = flat.float() / safe[:, None]
        u = _hash_uniform(seed, tuple(flat.shape), self.row0, device=x.device, shard=shard)
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

    def encode_shard(self, x, seed, shard, scale=None):
        """The shard's levels (this rank's) and the node's scale (every
        rank's)."""
        return self.encode(x, seed, scale, shard=shard)

    def decode_shard(self, packed, shard):
        return self.decode(packed)

    def whole_payload(self, packed, shard):
        q = packed.data["q"]
        q = shard.gather(q.reshape((q.shape[0],) + shard.shape)).reshape(q.shape[0], -1)
        return Packed({**packed.data, "q": q}, meta=(shard.whole,) + packed.meta[1:])

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
        # first slots).  A node row at a time: the sort's int64 indices
        # and buffers are O(d)
        idx = torch.empty((flat.shape[0], k), dtype=torch.int32, device=flat.device)
        for i in range(flat.shape[0]):
            order = torch.sort(-flat[i].float().abs(), stable=True).indices
            idx[i] = order[:k]
            del order
        return idx

    def encode(self, x, seed, scale=None, shard: Optional[Shard] = None):
        flat, shape = _flat(x)
        flat = flat.contiguous()
        d = flat.shape[1]
        if shard is None:
            k = self.k_for(d)
            idx = self._indices(flat, seed, k)
            vals = fused.call("top_k_pack", flat, idx)
        else:
            k = self.k_for(shard.d)
            idx, vals = self._shard_select(flat, seed, k, shard)
        if scale is not None:
            # adaptive ratio: keep the first ceil(scale * k) slots (the
            # largest magnitudes) and zero the rest; the payload keeps its shape
            k_eff = min(max(math.ceil(np.float32(k) * np.float32(scale)), 1), k)
            keep = torch.arange(k, device=x.device)[None, :] < k_eff
            vals = torch.where(keep, vals, torch.zeros((), dtype=vals.dtype, device=x.device))
        return Packed({"idx": idx, "vals": vals}, meta=(shape, x.dtype, d),
                      shared=() if shard is None else ("idx", "vals"))

    def decode(self, packed):
        shape, dtype, d = packed.meta
        idx, vals = packed.data["idx"], packed.data["vals"]
        dense = fused.call("top_k_unpack", idx, vals, d=d)
        return dense.reshape((idx.shape[0],) + shape).to(dtype)

    def _shard_select(self, flat, seed, k, shard):
        """The whole leaf's k indices (int32) and values from this rank's
        shard: the shard's best candidates, gathered and merged in the
        whole leaf's stable order, the same on every rank."""
        cand = self._indices(flat, seed, min(k, flat.shape[1]))
        vals = fused.call("top_k_pack", flat, cand)
        # whole-leaf indices as int32, as the payload holds them: 8 B a
        # candidate with its value
        got = shard.group.gather([shard.to_global(cand.long()).to(torch.int32), vals],
                                 key="codec")
        g = torch.cat([p[0] for p in got], dim=1)
        v = torch.cat([p[1] for p in got], dim=1)
        del got
        idx = torch.empty((flat.shape[0], k), dtype=torch.int32, device=flat.device)
        out = torch.empty((flat.shape[0], k), dtype=flat.dtype, device=flat.device)
        for i in range(flat.shape[0]):
            # by index first, then stably by descending |x|: ties to the
            # lower whole-leaf index, as the whole leaf's sort orders them
            by_index = torch.sort(g[i]).indices
            order = by_index[torch.sort(-v[i, by_index].float().abs(), stable=True).indices[:k]]
            idx[i] = g[i, order]
            out[i] = v[i, order]
        return idx, out

    def encode_shard(self, x, seed, shard, scale=None):
        """The whole leaf's payload, on every rank (``shared``)."""
        return self.encode(x, seed, scale, shard=shard)

    def decode_shard(self, packed, shard):
        """This shard of the whole leaf's decoded message: the entries in
        the shard, re-indexed; the rest padded as +0.0 added at spread
        in-shard indices, which changes no bit of an fp32 sum from +0.0."""
        shape, dtype, d = packed.meta
        idx, vals = packed.data["idx"], packed.data["vals"]
        local, inside = shard.to_local(idx.long())
        spread = torch.arange(idx.shape[1], device=idx.device) % d
        local = torch.where(inside, local, spread).to(torch.int32)
        vals = torch.where(inside, vals, torch.zeros((), dtype=vals.dtype, device=vals.device))
        dense = fused.call("top_k_unpack", local, vals, d=d)
        return dense.reshape((idx.shape[0],) + shape).to(dtype)

    def whole_payload(self, packed, shard):
        shape, dtype, _ = packed.meta
        return Packed(dict(packed.data), meta=(shard.whole, dtype, shard.d))

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

    def _shard_select(self, flat, seed, k, shard):
        """The whole leaf's draw on every rank; each rank packs the entries
        in its shard, and each slot takes its owner's value."""
        draw = self.index_draw or _randperm_draw
        whole = torch.as_tensor(draw(seed, shard.d, k)).to(device=flat.device,
                                                            dtype=torch.int64)
        local, inside = shard.to_local(whole)
        local = torch.where(inside, local, 0).to(torch.int32)
        mine = fused.call("top_k_pack", flat, local[None].expand(flat.shape[0], k).contiguous())
        got = shard.group.gather([mine], key="codec")
        owner = shard.owner(whole)
        vals = got[0][0]
        for r in range(1, shard.group.size):
            vals = torch.where(owner == r, got[r][0], vals)
        idx = whole.to(torch.int32)[None].expand(flat.shape[0], k).contiguous()
        return idx, vals.contiguous()


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

    @staticmethod
    def _sides(shard):
        """The group splitting the matrix rows (the leaf's dim 0; None where
        none does) and the (group, column-shape dim) of each splitting its
        columns."""
        rows = next((g for g, d in shard.cuts if d == 0), None)
        return rows, [(g, d - 1) for g, d in shard.cuts if d > 0]

    def encode_shard(self, x, seed, shard, scale=None):
        """The whole leaf's factors (see the module docstring): ``M Q0``
        from the shard's columns of the sketch, summed over the column
        groups, its row blocks concatenated over the row group; ``Mᵀ P``
        summed over the row group.  A factor every rank of the node holds
        whole is ``shared``."""
        del scale
        shape, n = tuple(x.shape[1:]), x.shape[0]
        plan = self._plan(shard.whole)
        if plan is None:
            return Packed({"raw": x}, meta=(shape, x.dtype, None))
        m, nn, r = plan
        draw = self.sketch_draw or _normal_draw
        q0 = torch.as_tensor(draw(seed, nn, r)).to(device=x.device, dtype=torch.float32)
        rows, cols = self._sides(shard)
        mat = x.reshape(n, shape[0], -1).float()
        if cols:
            # the whole leaf's column of each of this shard's columns
            idx = torch.arange(mat.shape[2], device=x.device)
            sub = list(shape[1:])
            for g, d in cols:
                k, sub[d] = sub[d], shard.whole[d + 1]
                idx = _to_global(idx, tuple(sub), d, g.index * k, k)
            y = mat @ q0[idx]
            for g, _ in cols:
                y = g.all_reduce(y, key="codec")
        else:
            y = mat @ q0
        if rows is None:
            p = torch.linalg.qr(y).Q
            q = torch.einsum("nmc,nmr->ncr", mat, p)
            return Packed({"p": p, "q": q}, meta=(shape, x.dtype, plan), shared=("p",))
        y = torch.cat([p[0] for p in rows.gather([y], key="codec")], dim=1)
        lo = rows.index * shape[0]
        p = torch.linalg.qr(y).Q[:, lo:lo + shape[0]].contiguous()
        q = rows.all_reduce(torch.einsum("nmc,nmr->ncr", mat, p), key="codec")
        return Packed({"p": p, "q": q}, meta=(shape, x.dtype, plan),
                      shared=() if cols else ("q",))

    def decode_shard(self, packed, shard):
        return self.decode(packed)

    def whole_payload(self, packed, shard):
        _, dtype, plan = packed.meta
        meta = (shard.whole, dtype, plan)
        if plan is None:
            return Packed({"raw": shard.gather(packed.data["raw"])}, meta=meta)
        p, q = packed.data["p"], packed.data["q"]
        rows, cols = self._sides(shard)
        if rows is not None:
            p = rows.all_gather([p], [1])[0]
        if cols:
            # this rank's rows of Q are its columns of the leaf: gather them
            # along the leaf's sharded dims, then flatten again
            n, r = q.shape[0], q.shape[-1]
            q = q.reshape((n,) + shard.shape[1:] + (r,))
            for g, d in cols:
                q = g.all_gather([q], [d + 1])[0]
            q = q.reshape(n, -1, r)
        return Packed({"p": p, "q": q}, meta=meta)

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
