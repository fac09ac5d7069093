"""Plain PyTorch versions of the codecs' ops: QSGD quantize / dequantize
and the top-k pack / unpack, and PyTorch mirrors of the top-k kernels'
algorithms (``top_k_unpack_tiled_ref``, ``top_k_pack_windowed_ref``), which
the tests and the smoke run and no path of the port calls."""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "qsgd_quantize_ref", "qsgd_dequantize_ref", "top_k_pack_ref", "top_k_unpack_ref",
    "top_k_unpack_tiled_ref", "top_k_pack_windowed_ref",
]


def qsgd_quantize_ref(x: torch.Tensor, u: torch.Tensor, levels) -> torch.Tensor:
    """sign(x) * min(floor(|x| * levels + u), levels) in fp32, in x's dtype.

    The product and the add are two roundings (no FMA), as in the
    reference and in the kernel, so the levels agree bit for bit."""
    xf = x.float()
    lv = float(np.float32(levels))
    q = torch.floor(xf.abs() * lv + u.float())
    return (torch.sign(xf) * torch.clamp(q, max=lv)).to(x.dtype)


def qsgd_dequantize_ref(q: torch.Tensor, scale: torch.Tensor, inv_levels) -> torch.Tensor:
    """q * scale * (1/levels) in fp32, in the SCALE's dtype (q is the int8
    payload on the codec's path)."""
    out = q.float() * scale.float() * float(np.float32(inv_levels))
    return out.to(scale.dtype)


def top_k_pack_ref(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """vals[i, j] = x[i, idx[i, j]]: the gather behind the packed payload."""
    return torch.gather(x, 1, idx.long())


def top_k_unpack_ref(idx: torch.Tensor, vals: torch.Tensor, d: int) -> torch.Tensor:
    """Dense (N, d) in vals' dtype: zeros, then a per-row scatter-add of
    vals at idx."""
    out = torch.zeros((idx.shape[0], int(d)), dtype=vals.dtype, device=vals.device)
    return out.scatter_add_(1, idx.long(), vals)


def top_k_unpack_tiled_ref(idx: torch.Tensor, vals: torch.Tensor, d: int,
                           tile: int) -> torch.Tensor:
    """The unpack kernel's algorithm (``csrc/top_k.cu``) in PyTorch.

    Each row is cut into tiles of ``tile`` elements.  A row of at most one
    tile adds its entries straight into an fp32 accumulator.  Longer rows
    go through a counting sort by output tile: count the entries of each
    (row, tile), scan the counts into bucket starts, place each entry's
    in-tile offset and fp32 value in its bucket (here in input order; the
    kernel's order inside a bucket is unspecified), then zero each tile's
    accumulator, add its bucket and round the tile once to ``vals``' dtype.
    An index outside [0, d) is ignored.  The sums are fp32, as in the TPU
    kernel, so repeated indices give its result and not the plain
    version's running bf16 sum."""
    if not 0 < tile <= 65536:
        raise ValueError(f"tile must be in (0, 65536] (a 16-bit in-tile offset), got {tile}")
    n, k = idx.shape
    d = int(d)
    j = idx.long()
    v = vals.float()
    valid = (j >= 0) & (j < d)
    rows = torch.arange(n, device=idx.device).unsqueeze(1).expand(n, k)[valid]
    j, v = j[valid], v[valid]
    if d <= tile:
        acc = torch.zeros((n, d), dtype=torch.float32, device=idx.device)
        acc.index_put_((rows, j), v, accumulate=True)
        return acc.to(vals.dtype)
    p = -(-d // tile)
    owner = rows * p + j // tile                       # (row, tile) of each entry
    counts = torch.bincount(owner, minlength=n * p)    # count
    starts = torch.cumsum(counts, 0) - counts          # scan
    order = torch.argsort(owner, stable=True)          # place
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=idx.device) - starts[owner[order]]
    pos = starts[owner] + rank
    bucket_off = torch.empty_like(j)
    bucket_val = torch.empty_like(v)
    bucket_off[pos] = j % tile
    bucket_val[pos] = v
    bucket_tile = torch.repeat_interleave(torch.arange(n * p, device=idx.device), counts)
    acc = torch.zeros((n * p, tile), dtype=torch.float32, device=idx.device)   # tile
    acc.view(-1).index_add_(0, bucket_tile * tile + bucket_off, bucket_val)
    return acc.view(n, p * tile)[:, :d].to(vals.dtype)


def top_k_pack_windowed_ref(x: torch.Tensor, idx: torch.Tensor, window: int) -> torch.Tensor:
    """The pack kernel's algorithm (``csrc/top_k.cu``) in PyTorch: one pass
    per window of ``window`` elements of each row, each gathering only the
    entries whose index falls in its window.  An index outside [0, d) gives
    0 (written by the first pass)."""
    if window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    d = x.shape[1]
    j = idx.long()
    vals = torch.zeros(idx.shape, dtype=x.dtype, device=x.device)
    for lo in range(0, d, window):
        hi = min(d, lo + window)
        hit = (j >= lo) & (j < hi)
        vals[hit] = torch.gather(x, 1, j.clamp(lo, hi - 1))[hit]
    return vals
