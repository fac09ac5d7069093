"""The top-k kernels' algorithms, mirrored on the CPU.

The CUDA unpack (``csrc/top_k.cu``) sorts the kept entries by output tile
(count, scan, place) and then writes each tile once from an fp32
accumulator; a row of at most one tile adds its entries straight into the
accumulator.  The CUDA pack gathers a long row of x in passes over windows
of it.  ``top_k_unpack_tiled_ref`` and ``top_k_pack_windowed_ref`` compute
those algorithms in PyTorch.  The same numpy inputs go through them,
through the plain versions (``torch.gather``; ``zeros`` + ``scatter_add_``)
and through the reference's Pallas kernels in interpret mode.

Tolerance: none, bit for bit.  With distinct indices every unpacked slot
is one add into zero and every packed value a copied element.  Repeated
indices are summed in fp32 by the mirror and the Pallas kernel alike, in
different orders, so their values are drawn as multiples of 2**-6 below 1
in magnitude (bf16-exact), whose fp32 sums are exact in any order.  Sizes:
tiles of 64 cover several tiles, a ragged last tile, empty buckets, every
index in one tile, k = 0, k = d and rows shorter than a tile; one case runs
at the kernel's own tile of 16,384.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.comm_compress.kernel import top_k_pack_fwd, top_k_unpack_fwd
from repro_torch.kernels.comm_compress.kernel import (
    PACK_SPLIT_BYTES,
    UNPACK_TILE,
    pack_window,
    unpack_scratch_bytes,
)
from repro_torch.kernels.comm_compress.ref import (
    top_k_pack_ref,
    top_k_pack_windowed_ref,
    top_k_unpack_ref,
    top_k_unpack_tiled_ref,
)

TILE = 64
BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.float16: torch.int16}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}

# (label, n, d, k, tile): several tiles with a ragged last one, a last tile
# of one element, mostly empty buckets, k = 0, k = d, d below and at one
# tile, and the kernel's tile over a ragged third tile
UNPACK_CASES = [
    ("several_tiles", 3, 1000, 100, TILE),
    ("last_tile_of_one", 2, 2 * TILE + 1, 40, TILE),
    ("empty_buckets", 2, 4096, 5, TILE),
    ("k0", 3, 700, 0, TILE),
    ("k_eq_d", 2, 300, 300, TILE),
    ("d_below_tile", 4, 50, 20, TILE),
    ("d_is_tile", 2, TILE, 10, TILE),
    ("kernel_tile", 2, 2 * UNPACK_TILE + 5, 3000, UNPACK_TILE),
]


def _bits(t):
    return t.contiguous().view(BITS[t.dtype])


def _distinct(rng, n, d, k, lo=0, hi=None):
    hi = d if hi is None else hi
    return np.stack([rng.choice(np.arange(lo, hi), k, replace=False) for _ in range(n)]
                    ).astype(np.int32).reshape(n, k)


def _values(rng, n, k, dtype):
    v = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).to(dtype)
    if v.numel():
        v.view(-1)[0] = -0.0   # lands as +0 everywhere
    return v


def _interpret_unpack(idx, vals, d):
    jv = jnp.asarray(vals.float().numpy()).astype(JNP[vals.dtype])
    out = top_k_unpack_fwd(jnp.asarray(idx.numpy()), jv, d=d, interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32))).to(vals.dtype)


def _interpret_pack(x, idx):
    jx = jnp.asarray(x.float().numpy()).astype(JNP[x.dtype])
    out = top_k_pack_fwd(jx, jnp.asarray(idx.numpy()), interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32))).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("label,n,d,k,tile", UNPACK_CASES)
def test_tiled_unpack_matches_plain_and_pallas_for_distinct_indices(label, n, d, k, tile, dtype):
    rng = np.random.default_rng(d + k)
    idx = torch.from_numpy(_distinct(rng, n, d, k))
    vals = _values(rng, n, k, dtype)
    got = top_k_unpack_tiled_ref(idx, vals, d, tile)
    assert got.dtype == dtype and got.shape == (n, d)
    assert torch.equal(_bits(got), _bits(top_k_unpack_ref(idx, vals, d)))
    if k:   # the Pallas kernel takes no empty (1, k) block
        assert torch.equal(_bits(got), _bits(_interpret_unpack(idx, vals, d)))
    assert not bool((torch.signbit(got) & (got == 0)).any())   # no -0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_unpack_with_every_index_in_one_tile(dtype):
    """Skew: every entry of each row falls in tile 5 of 16; the other
    buckets are empty."""
    rng = np.random.default_rng(7)
    n, d, k = 3, 1000, 50
    idx = torch.from_numpy(_distinct(rng, n, d, k, 5 * TILE, 6 * TILE))
    vals = _values(rng, n, k, dtype)
    got = top_k_unpack_tiled_ref(idx, vals, d, TILE)
    assert torch.equal(_bits(got), _bits(top_k_unpack_ref(idx, vals, d)))
    assert torch.equal(_bits(got), _bits(_interpret_unpack(idx, vals, d)))
    assert not bool(got[:, : 5 * TILE].any() or got[:, 6 * TILE:].any())


def _exact_repeats(rng, n, d, k, dtype):
    """Indices with repeats (a few slots hit many times) and values whose
    fp32 sums are exact in any order: multiples of 2**-6 below 1."""
    idx = rng.integers(0, d, (n, k)).astype(np.int32)
    idx[:, : k // 4] = idx[:, :1]            # one slot a quarter of the row
    vals = rng.integers(-63, 64, (n, k)).astype(np.float32) / 64
    return torch.from_numpy(idx), torch.from_numpy(vals).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("label,n,d,k,tile", [
    ("several_tiles", 3, 1000, 400, TILE),
    ("d_below_tile", 2, 50, 120, TILE),
    ("kernel_tile", 2, 2 * UNPACK_TILE + 5, 5000, UNPACK_TILE),
])
def test_tiled_unpack_sums_repeated_indices_as_the_pallas_kernel(label, n, d, k, tile, dtype):
    rng = np.random.default_rng(3 * d + k)
    idx, vals = _exact_repeats(rng, n, d, k, dtype)
    got = top_k_unpack_tiled_ref(idx, vals, d, tile)
    assert torch.equal(_bits(got), _bits(_interpret_unpack(idx, vals, d)))
    # the sums themselves, exact in float64 and rounded once to the dtype
    want = np.zeros((n, d))
    np.add.at(want, (np.arange(n)[:, None], idx.numpy()), vals.double().numpy())
    assert torch.equal(_bits(got), _bits(torch.from_numpy(want).to(dtype)))


@pytest.mark.parametrize("tile", [TILE, UNPACK_TILE])
def test_tiled_unpack_ignores_indices_outside_the_row(tile):
    rng = np.random.default_rng(17)
    n, d, k = 2, 3 * tile - 7, 30
    idx = _distinct(rng, n, d, k)
    idx[:, ::5] = np.resize([-1, d, d + 600, 2**31 - 1, -(2**31)], idx[:, ::5].shape)
    idx, vals = torch.from_numpy(idx), _values(rng, n, k, torch.float32)
    got = top_k_unpack_tiled_ref(idx, vals, d, tile)
    stray = (idx < 0) | (idx >= d)
    want = top_k_unpack_ref(torch.where(stray, 0, idx), torch.where(stray, 0.0, vals), d)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got), _bits(_interpret_unpack(idx, vals, d)))


def test_tiled_unpack_refuses_tiles_past_a_16_bit_offset():
    idx = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="16-bit"):
        top_k_unpack_tiled_ref(idx, torch.ones((1, 1)), 10, 2**17)


# (label, n, d, k, window): one window, several with a ragged last one, a
# window of one element, k = 0, k = d
PACK_CASES = [
    ("one_window", 3, 1000, 100, 1000),
    ("several_windows", 3, 1000, 100, 300),
    ("windows_of_one", 2, 40, 12, 1),
    ("k0", 2, 500, 0, 64),
    ("k_eq_d", 2, 300, 300, 128),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("label,n,d,k,window", PACK_CASES)
def test_windowed_pack_matches_plain_and_pallas(label, n, d, k, window, dtype):
    rng = np.random.default_rng(d + k + window)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dtype)
    idx = torch.from_numpy(_distinct(rng, n, d, k))
    got = top_k_pack_windowed_ref(x, idx, window)
    assert got.dtype == dtype and got.shape == (n, k)
    assert torch.equal(_bits(got), _bits(top_k_pack_ref(x, idx)))
    if k:
        assert torch.equal(_bits(got), _bits(_interpret_pack(x, idx)))


def test_windowed_pack_with_every_index_in_one_window_and_strays():
    """Skew into window 2 of 4, and indices outside [0, d), which give 0
    (as the Pallas kernel's one-hot does)."""
    rng = np.random.default_rng(23)
    n, d, k, window = 3, 1000, 60, 250
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    idx = _distinct(rng, n, d, k, 2 * window, 3 * window)
    idx[:, ::7] = np.resize([-1, d, d + 5, -300, 2**31 - 1, 1234, -2], idx[:, ::7].shape)
    idx = torch.from_numpy(idx)
    got = top_k_pack_windowed_ref(x, idx, window)
    stray = (idx < 0) | (idx >= d)
    assert not bool(got[stray].any())
    want = torch.where(stray, 0.0, top_k_pack_ref(x, torch.where(stray, 0, idx)))
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got), _bits(_interpret_pack(x, idx)))


def test_pack_windows_and_unpack_scratch_sizes():
    """The wrapper's sizes: two pack windows of a 2**24 + 3 row in fp32 and
    bf16 (rows above PACK_SPLIT_BYTES), one at the MLP's leaves; sort
    scratch only for rows longer than one tile."""
    d = 2**24 + 3
    for eb in (4, 2):
        assert d * eb > PACK_SPLIT_BYTES and -(-d // pack_window(d, eb)) == 2
    assert pack_window(PACK_SPLIT_BYTES // 4, 4) == PACK_SPLIT_BYTES // 4
    for d_leaf in (12544, 64, 640, 10):
        assert pack_window(d_leaf, 4) == d_leaf
        assert unpack_scratch_bytes(8, d_leaf, 7, torch.float32) == 0
    nt = 8 * 1025
    assert unpack_scratch_bytes(8, d, 1677722, torch.float32) == 4 * nt + 8 * nt + 8 * 8 * 1677722
    assert unpack_scratch_bytes(1, UNPACK_TILE + 1, 3, torch.bfloat16) == 8 + 16 + 12
