"""The port's Triton and CUDA C++ kernels and launch counts on a CUDA card.

Every test here carries the ``cuda`` marker and skips without a card.  The
file imports neither JAX nor ``repro``, so it runs on a machine with torch,
Triton and a card alone:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances, kernel vs its plain version on the same card: fp32 rtol 1e-6 /
atol 1e-6 (Triton may contract a multiply-add into an FMA, one ulp); bf16
within one bf16 ulp beyond that; the QSGD ops exactly (integer levels, and
the quantize is built without FMA contraction); the top-k pack and unpack
exactly (a gather copies bits; with distinct indices each unpacked slot is
one add into zero; with repeated ones the unpack's fp32 sums are held to its
tiled mirror on values whose sums are exact in any order); flash attention and rms_norm in fp32 within rtol 1e-5 /
atol 1e-5 (other summation orders, the hardware's rsqrt) and in bf16 (and
rms_norm in fp16) within one ulp of that type beyond that (both compute in
fp32 and round once); wkv_chunk
within rtol / atol 1e-5 of the plain chunked form under any decay (the same
fp32 arithmetic in other orders) and within rtol 2e-4 / atol 2e-5 of the
per-token recurrence inside the clamp envelope (the reference's own
kernel-test tolerance).  Gradients through the kernels (the backward is
the plain version's gradient, recomputed): the flash op's bit for bit those
of the plain forward's graph on the same inputs, the elementwise ops'
within rtol / atol 1e-6 of the CPU's (bf16 one ulp beyond), and the reduced
Qwen2-VL loss's within 1e-4 of each parameter's largest |gradient| of the
plain forward's (the kernel's forward rounds in another order).
"""
import re

import numpy as np
import pytest
import torch

from repro_torch import paper_problem as tproblem
from repro_torch.core import Simulator, ring
from repro_torch.kernels import api

pytestmark = pytest.mark.cuda

N_NODES, TAU, BATCH = 8, 4, 16
# odd sizes (ragged tails) and two dtype buckets
LEAVES = {"a": ((3, 7), torch.float32), "b": ((1001,), torch.bfloat16),
          "c": ((5, 13), torch.float32), "e": ((2, 3, 5), torch.bfloat16)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _normal(gen, shape, dtype):
    return torch.randn(shape, generator=gen).to(dtype)


def _unit(gen, shape, dtype):
    return (torch.rand(shape, generator=gen) * 2 - 1).to(dtype)


def _uniform01(gen, shape, dtype):
    return torch.rand(shape, generator=gen).to(dtype)


def _levels(gen, shape, dtype):
    return torch.randint(-127, 128, shape, generator=gen).to(torch.int8)


def _positive(gen, shape, dtype):
    return (torch.rand(shape, generator=gen) * 1.9 + 0.1).to(dtype)


OPS = {
    "mvr_update": ((0.05,), (_normal,) * 3),
    "axpby": ((-0.3, 1.0), (_normal,) * 2),
    "add_sub": ((), (_normal,) * 3),
    "dse_combine": ((0.3,), (_normal,) * 4),
    "dse_combine_yh": ((0.3,), (_normal,) * 5),
    "qsgd_quantize": ((127.0,), (_unit, _uniform01)),
    "qsgd_dequantize": ((1.0 / 127,), (_levels, _positive)),
}


def _ulp(x, bits=8):
    """One ulp of x in a float type of ``bits`` significand bits (bf16 8,
    fp16 11)."""
    _, e = torch.frexp(x.abs())
    return torch.ldexp(torch.ones_like(x), e - bits)


@pytest.mark.parametrize("name", sorted(OPS))
def test_kernel_matches_plain(name, cuda_device):
    scalars, makers = OPS[name]
    gen = torch.Generator().manual_seed(11)
    trees = [{k: make(gen, s, d).to(cuda_device) for k, (s, d) in LEAVES.items()}
             for make in makers]
    api.reset_counters()
    got = api.tree_apply(name, *trees, scalars=scalars)
    torch.cuda.synchronize()
    assert api.launch_counts() == {name: 2}          # one per dtype bucket
    with api.dispatch_mode("ref"):
        want = api.tree_apply(name, *trees, scalars=scalars)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g_tree, w_tree in zip(got, want):
        for k, (_, dtype) in LEAVES.items():
            g, w = g_tree[k], w_tree[k]
            assert g.dtype == w.dtype == dtype
            if name.startswith("qsgd"):
                assert torch.equal(g, w), k
            elif dtype == torch.bfloat16:
                g, w = g.float(), w.float()
                excess = ((g - w).abs() - 1e-6).clamp(min=0)
                assert bool(torch.all(excess <= _ulp(torch.maximum(g.abs(), w.abs()))))
            else:
                torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_kernels_refuse_what_they_do_not_take(cuda_device):
    x = torch.ones(10, device=cuda_device)
    with pytest.raises(ValueError, match="unsupported output dtype"):
        api.get("axpby").launch((1.0, 1.0), (x, x), (torch.empty(10, dtype=torch.int8,
                                                                  device=cuda_device),))
    with pytest.raises(ValueError, match="contiguous"):
        api.get("axpby").launch((1.0, 1.0), (x, x[::2].repeat(2)[:9]), (x,))


def _sim(name, device, **kw):
    data, _ = tproblem.make_paper_problem(0.5, seed=0)
    alg = tproblem.make_algorithm(name, 0.3, TAU, 200, use_fused=True, **kw)
    return Simulator(alg, ring(N_NODES), tproblem.mlp_loss, data, BATCH, device=device)


def test_fused_gt_hsgd_step_launches_one_kernel_per_op(cuda_device):
    """On the fp32 MLP tree, a fused GT-HSGD step launches exactly one
    axpby, one mvr_update and one add_sub."""
    sim = _sim("gt_hsgd", cuda_device)
    state = sim.init_state(tproblem.mlp_init(0))
    api.reset_counters()
    sim.run_rounds(state, 1)
    torch.cuda.synchronize()
    assert api.launch_counts() == {"axpby": 1, "mvr_update": 1, "add_sub": 1}


def test_compressed_comm_event_launches_eight_of_each_qsgd_op(cuda_device):
    """A QSGD-compressed DSE-MVR communication event launches 8 quantizes
    and 8 dequantizes (4 leaves x 2 buffers) and leaves finite residuals."""
    sim = _sim("dse_mvr", cuda_device, compression="qsgd")
    state = sim.init_state(tproblem.mlp_init(0))
    api.reset_counters()
    state = sim.run_rounds(state, 1)
    torch.cuda.synchronize()
    counts = api.launch_counts()
    assert counts["qsgd_quantize"] == counts["qsgd_dequantize"] == 8
    assert state.comp.event == 1
    for wire in state.comp.wire:
        for leaf in wire["res"].values():
            assert bool(torch.isfinite(leaf).all())
    assert np.isfinite(sim.evaluate(state)["train_loss"])


def test_dropout_scenario_through_the_kernels_matches_the_cpu(cuda_device):
    """A reduced ``dropout_ring`` DSE-MVR run (32 steps) through the kernels,
    with the dropout gate and the streams on the card, against the same
    formulas' plain versions on the CPU from the same indices: history in the main-path band
    (rtol 5e-4 / atol 1e-5), the consensus, tracking-error and
    spectral-gap streams within the same rtol, ``active_nodes`` exactly."""
    from repro_torch.scenarios import make_scenario

    data, _ = tproblem.make_paper_problem(0.5, seed=0)
    idx = torch.randint(0, data.samples_per_node, (32, N_NODES, BATCH),
                        generator=torch.Generator().manual_seed(3))
    outs = {}
    for dev in (cuda_device, torch.device("cpu")):
        alg = tproblem.make_algorithm("dse_mvr", 0.3, TAU, 32, use_fused=True)
        sim = Simulator(alg, None, tproblem.mlp_loss, data, BATCH,
                        scenario=make_scenario("dropout_ring"), device=dev,
                        index_fn=lambda s, i=idx.to(dev): i[s])
        api.reset_counters()
        outs[dev.type] = (sim.run(tproblem.mlp_init(0), 32, eval_every=16), api.launch_counts())
    (got, launches), (want, _) = outs["cuda"], outs["cpu"]
    assert launches["mvr_update"] > 0 and launches["dse_combine_yh"] > 0, launches
    assert got["state"].params["w1"].is_cuda
    for g, w in zip(got["history"], want["history"]):
        for k in ("train_loss", "consensus"):
            np.testing.assert_allclose(g[k], w[k], rtol=5e-4, atol=1e-5, err_msg=k)
    for k in ("consensus", "tracking_err", "spectral_gap"):
        np.testing.assert_allclose(got["streams"][k], want["streams"][k], rtol=5e-4,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(got["streams"]["active_nodes"],
                                  want["streams"]["active_nodes"])
    assert got["streams"]["active_nodes"].min() < N_NODES


# --------------------------------------------------------- top-k (CUDA C++)
# (N, d, k): the MLP's leaves at ratio 0.1, ragged sizes, k = d, and one row;
# rows just under, at and just over the unpack's tile of 16,384, several
# tiles with a ragged last one, and k = d over several tiles
TOP_K_SHAPES = [(8, 12544, 1255), (8, 64, 7), (8, 640, 64), (8, 10, 1), (3, 777, 13),
                (5, 33, 33), (1, 1001, 100),
                (2, 16383, 1639), (2, 16384, 1639), (2, 16385, 1639),
                (3, 3 * 16384 + 7, 5000), (2, 20000, 20000)]


def _distinct_indices(gen, n, d, k, device):
    return torch.stack([torch.randperm(d, generator=gen)[:k] for _ in range(n)]).to(
        device=device, dtype=torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", TOP_K_SHAPES)
def test_top_k_pack_matches_plain_bit_for_bit(shape, dtype, cuda_device):
    n, d, k = shape
    gen = torch.Generator().manual_seed(d + k)
    x = torch.randn((n, d), generator=gen).to(cuda_device, dtype)
    idx = _distinct_indices(gen, n, d, k, cuda_device)
    api.reset_counters()
    got = api.call("top_k_pack", x, idx)
    torch.cuda.synchronize()
    assert api.launch_counts() == {"top_k_pack": 1}
    with api.dispatch_mode("ref"):
        want = api.call("top_k_pack", x, idx)
    assert got.dtype == want.dtype == dtype and got.shape == (n, k)
    assert torch.equal(got.view(torch.int16 if dtype != torch.float32 else torch.int32),
                       want.view(torch.int16 if dtype != torch.float32 else torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", TOP_K_SHAPES)
def test_top_k_unpack_matches_plain_bit_for_bit(shape, dtype, cuda_device):
    n, d, k = shape
    gen = torch.Generator().manual_seed(3 * d + k)
    vals = torch.randn((n, k), generator=gen).to(cuda_device, dtype)
    vals[0, 0] = -0.0          # a signed zero lands as +0, as in the plain version
    idx = _distinct_indices(gen, n, d, k, cuda_device)
    out = torch.full((n, d), 7.0, dtype=dtype, device=cuda_device)   # dirty the pool
    del out
    api.reset_counters()
    got = api.call("top_k_unpack", idx, vals, d=d)
    torch.cuda.synchronize()
    assert api.launch_counts() == {"top_k_unpack": 1}
    with api.dispatch_mode("ref"):
        want = api.call("top_k_unpack", idx, vals, d=d)
    assert got.dtype == want.dtype == dtype and got.shape == (n, d)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got.view(bits), want.view(bits))


def test_top_k_kernels_handle_odd_offsets_and_empty_shapes(cuda_device):
    """Small odd outputs drive the tile store's single-element head and
    tail; k = 0 leaves zeros, on rows of one tile and of several."""
    gen = torch.Generator().manual_seed(5)
    for n, d in ((1, 1), (1, 3), (2, 5), (3, 7), (1, 9)):
        idx = _distinct_indices(gen, n, d, 1, cuda_device)
        vals = torch.randn((n, 1), generator=gen).to(cuda_device)
        got = api.call("top_k_unpack", idx, vals, d=d)
        with api.dispatch_mode("ref"):
            want = api.call("top_k_unpack", idx, vals, d=d)
        assert torch.equal(got, want)
    empty = torch.empty((4, 0), dtype=torch.int32, device=cuda_device)
    x = torch.randn((4, 6), device=cuda_device)
    assert api.call("top_k_pack", x, empty).shape == (4, 0)
    dense = api.call("top_k_unpack", empty, torch.empty((4, 0), device=cuda_device), d=6)
    assert torch.equal(dense, torch.zeros((4, 6), device=cuda_device))
    dense = api.call("top_k_unpack", empty, torch.empty((4, 0), device=cuda_device), d=40000)
    assert torch.equal(dense, torch.zeros((4, 40000), device=cuda_device))


def test_top_k_kernels_refuse_what_they_do_not_take(cuda_device):
    x = torch.randn((4, 10), device=cuda_device)
    idx = torch.zeros((4, 3), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="idx dtype"):
        api.call("top_k_pack", x, idx.long())
    with pytest.raises(ValueError, match="contiguous"):
        api.call("top_k_pack", x.t().contiguous().t(), idx)
    with pytest.raises(ValueError, match="one CUDA device"):
        api.call("top_k_pack", x, idx.cpu())
    with pytest.raises(ValueError, match="vals dtype"):
        api.call("top_k_unpack", idx, torch.zeros((4, 3), dtype=torch.float16,
                                                  device=cuda_device), d=10)
    with pytest.raises(ValueError, match="shape"):
        api.call("top_k_unpack", idx, torch.zeros((4, 2), device=cuda_device), d=10)


def _same_bits(a, b):
    bits = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(bits), b.view(bits))


def _plain(name, *args, **kw):
    with api.dispatch_mode("ref"):
        return api.call(name, *args, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 12544, 3000), (3, 50, 200), (2, 3 * 16384 + 7, 20000)])
def test_top_k_unpack_sums_repeated_indices_as_the_tiled_mirror(shape, dtype, cuda_device):
    """Repeated indices, a quarter of each row on one slot, on rows of one
    tile and of several: the fp32 sums of the tiled mirror (the Pallas
    kernel's order of rounding).  The values are multiples of 2**-6 below 1,
    so the fp32 sums are exact in any order and the check is bit for bit."""
    from repro_torch.kernels.comm_compress.kernel import UNPACK_TILE
    from repro_torch.kernels.comm_compress.ref import top_k_unpack_tiled_ref

    n, d, k = shape
    gen = torch.Generator().manual_seed(d + k)
    idx = torch.randint(0, d, (n, k), generator=gen, dtype=torch.int32)
    idx[:, : k // 4] = idx[:, :1]
    vals = (torch.randint(-63, 64, (n, k), generator=gen).float() / 64).to(dtype)
    idx, vals = idx.to(cuda_device), vals.to(cuda_device)
    got = api.call("top_k_unpack", idx, vals, d=d)
    want = top_k_unpack_tiled_ref(idx, vals, d, UNPACK_TILE)
    assert _same_bits(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [12544, 3 * 16384 + 7])
def test_top_k_kernels_keep_subnormals_bit_for_bit(d, dtype, cuda_device):
    """Subnormal values (and their negatives) go through the pack's copy
    and the unpack's fp32 adds unflushed, on rows of one tile and of
    several.  The unpack is held to the plain version on the CPU: on the
    card the plain scatter_add_ adds by fp32 atomics, which may flush."""
    n, k = 4, 2000
    gen = torch.Generator().manual_seed(d)
    tiny = torch.finfo(dtype).tiny
    x = (torch.rand((n, d), generator=gen) * 2 - 1) * tiny   # |x| < the smallest normal
    x = x.to(dtype).to(cuda_device)
    assert bool(((x != 0) & (x.abs() < tiny)).sum() > n * d // 2)
    idx = _distinct_indices(gen, n, d, k, cuda_device)
    vals = api.call("top_k_pack", x, idx)
    assert _same_bits(vals, _plain("top_k_pack", x, idx))
    assert bool((vals != 0).any())
    got = api.call("top_k_unpack", idx, vals, d=d)
    assert _same_bits(got.cpu(), _plain("top_k_unpack", idx.cpu(), vals.cpu(), d=d))
    assert bool(((got != 0) & (got.abs() < tiny)).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_top_k_kernels_with_every_index_in_one_tile_or_window(dtype, cuda_device):
    """Skew: every index of a row in tile 3 of the unpack's 9, and (x at
    12M elements: two or three pack windows) in the pack's last window."""
    from repro_torch.kernels.comm_compress.kernel import UNPACK_TILE, pack_window

    gen = torch.Generator().manual_seed(3)
    n, d, k = 3, 9 * UNPACK_TILE - 5, 8000
    idx = torch.stack([torch.randperm(UNPACK_TILE, generator=gen)[:k] + 3 * UNPACK_TILE
                       for _ in range(n)]).to(cuda_device, torch.int32)
    vals = torch.randn((n, k), generator=gen).to(cuda_device, dtype)
    assert _same_bits(api.call("top_k_unpack", idx, vals, d=d),
                      _plain("top_k_unpack", idx, vals, d=d))
    d = 12_000_000
    x = torch.randn((n, d), generator=gen).to(cuda_device, dtype)
    window = pack_window(d, x.element_size())
    assert window < d
    idx = torch.stack([torch.randperm(d - (d - 1) // window * window, generator=gen)[:k]
                       + (d - 1) // window * window for _ in range(n)]).to(cuda_device,
                                                                         torch.int32)
    assert _same_bits(api.call("top_k_pack", x, idx), _plain("top_k_pack", x, idx))


@pytest.mark.parametrize("d", [777, 3 * 16384 + 7, 12_000_000])
def test_top_k_kernels_take_indices_outside_the_row(d, cuda_device):
    """An index outside [0, d) gives 0 in the pack and is ignored by the
    unpack: on one tile, several tiles, and several pack windows."""
    gen = torch.Generator().manual_seed(d)
    n, k = 2, 500
    x = torch.randn((n, d), generator=gen).to(cuda_device)
    idx = _distinct_indices(gen, n, d, k, cuda_device)
    stray = torch.zeros((n, k), dtype=torch.bool, device=cuda_device)
    stray[:, ::4] = True
    bad = torch.tensor([-1, d, d + 600, 2**31 - 1, -(2**31)], dtype=torch.int32,
                       device=cuda_device)
    idx = torch.where(stray, bad.repeat(k)[:k], idx)
    vals = api.call("top_k_pack", x, idx)
    want = torch.where(stray, 0.0, _plain("top_k_pack", x, torch.where(stray, 0, idx)))
    assert _same_bits(vals, want)
    vals = torch.randn((n, k), generator=gen).to(cuda_device)
    got = api.call("top_k_unpack", idx, vals, d=d)
    assert _same_bits(got, _plain("top_k_unpack", torch.where(stray, 0, idx),
                                  torch.where(stray, 0.0, vals), d=d))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_top_k_unpack_rows_of_more_than_4096_tiles(dtype, cuda_device):
    """Rows longer than 4,096 tiles count and reserve bucket space with one
    global atomic per entry instead of a shared-memory histogram."""
    from repro_torch.kernels.comm_compress.kernel import UNPACK_TILE

    gen = torch.Generator().manual_seed(4097)
    n, d, k = 1, 4097 * UNPACK_TILE + 5, 20000
    idx = _distinct_indices(gen, n, d, k, cuda_device)
    idx[0, :10] = torch.arange(d - 10, d, dtype=torch.int32, device=cuda_device)
    vals = torch.randn((n, k), generator=gen).to(cuda_device, dtype)
    assert _same_bits(api.call("top_k_unpack", idx, vals, d=d),
                      _plain("top_k_unpack", idx, vals, d=d))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_top_k_kernels_at_the_large_shape(dtype, cuda_device):
    """N = 8, d = 2**24 + 3, k = ceil(0.1 d), indices in magnitude order as
    the codec makes them: one 67 MB fp32 row is four pack windows and 1,025
    unpack tiles, bit for bit against the plain versions."""
    n, d = 8, 2**24 + 3
    k = -(-d // 10)
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    x = torch.randn((n, d), generator=gen, device=cuda_device).to(dtype)
    idx = torch.sort(-x.float().abs(), dim=1, stable=True).indices[:, :k]
    idx = idx.to(torch.int32).contiguous()
    api.reset_counters()
    vals = api.call("top_k_pack", x, idx)
    dense = api.call("top_k_unpack", idx, vals, d=d)
    torch.cuda.synchronize()
    assert api.launch_counts() == {"top_k_pack": 1, "top_k_unpack": 1}
    assert _same_bits(vals, _plain("top_k_pack", x, idx))
    assert _same_bits(dense, _plain("top_k_unpack", idx, vals, d=d))


def test_choco_top_k_comm_event_launches_eight_of_each_top_k_op(cuda_device):
    """A CHOCO top-k DSE-MVR communication event launches 8 packs and 8
    unpacks (4 leaves x 2 buffers) and no QSGD kernel."""
    sim = _sim("dse_mvr", cuda_device, compression="top_k:0.1", channel="choco")
    state = sim.init_state(tproblem.mlp_init(0))
    api.reset_counters()
    state = sim.run_rounds(state, 1)
    torch.cuda.synchronize()
    counts = api.launch_counts()
    assert counts["top_k_pack"] == counts["top_k_unpack"] == 8, counts
    assert "qsgd_quantize" not in counts
    for wire in state.comp.wire:
        for leaf in wire["hat"].values():
            assert bool(torch.isfinite(leaf).all())
    assert np.isfinite(sim.evaluate(state)["train_loss"])


# ----------------------------------------- flash attention (CUDA C++), rms_norm
# (b, s, h, kh, d, window, softcap, causal[, skv]): Gemma-2's D = 256 with
# GQA 2, window and softcap; D = 128 (Yi, Minitron); ragged lengths; D 32 /
# 64; a sequence that wraps the kv stage ring many times with the window's
# edge mid-sequence; Skv tails that are no multiple of any tile; GQA 12 as
# in Command R+; Sq != Skv without causality, both ways round; sequences
# shorter than one tile (the TMA boxes reach past the end)
FLASH_SHAPES = [
    (2, 256, 8, 4, 256, None, 50.0, True),
    (2, 300, 8, 4, 256, 64, 50.0, True),
    (1, 1000, 8, 2, 128, None, None, True),
    (2, 129, 4, 4, 128, 48, None, True),
    (1, 77, 4, 1, 64, None, 30.0, False),
    (1, 200, 2, 2, 32, 16, 50.0, True),
    (1, 2048, 16, 2, 256, 1024, 50.0, True),
    (1, 333, 8, 4, 256, None, 50.0, True),
    (2, 999, 8, 2, 128, 200, None, True),
    (1, 384, 12, 1, 128, None, None, True),
    (1, 200, 8, 4, 128, None, None, False, 517),
    (2, 300, 8, 2, 256, None, 30.0, False, 97),
    (1, 10, 8, 4, 256, None, 50.0, True),
    (2, 33, 4, 2, 128, None, None, True),
    # head dims between the instances, zero-padded: Zamba2's 112 to 128, 48 to 64
    (2, 300, 8, 8, 112, None, None, True),
    (1, 257, 4, 2, 112, 64, 50.0, True),
    (1, 200, 4, 2, 48, 16, None, True),
]


def _flash_case(case, dtype, device, seed=7):
    b, s, h, kh, d = case[:5]
    skv = case[8] if len(case) > 8 else s
    gen = torch.Generator().manual_seed(seed)
    q = (torch.randn((b, s, h, d), generator=gen) * 4).to(dtype).to(device)
    k = torch.randn((b, skv, kh, d), generator=gen).to(dtype).to(device)
    v = torch.randn((b, skv, kh, d), generator=gen).to(dtype).to(device)
    return q, k, v, dict(causal=case[7], sliding_window=case[5], softcap=case[6])


def _assert_kernel_close(got, want, rtol=1e-5, atol=1e-5):
    """fp32 within rtol / atol; bf16 and fp16 within one ulp of their own
    beyond that."""
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    excess = ((g - w).abs() - atol - rtol * w.abs()).clamp(min=0)
    bits = {torch.bfloat16: 8, torch.float16: 11}.get(got.dtype)
    if bits is not None:
        assert bool(torch.all(excess <= _ulp(torch.maximum(g.abs(), w.abs()), bits)))
    else:
        assert float(excess.max()) == 0.0, float((g - w).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_SHAPES)
def test_flash_attention_matches_plain(case, dtype, cuda_device):
    q, k, v, kw = _flash_case(case, dtype, cuda_device)
    api.reset_counters()
    got = api.call("flash_attention", q, k, v, **kw)
    torch.cuda.synchronize()
    assert api.launch_counts() == {"flash_attention": 1}
    with api.dispatch_mode("ref"):
        want = api.call("flash_attention", q, k, v, **kw)
    _assert_kernel_close(got, want)


# causal with a window and Sq > Skv + window: the last q-tiles hold no kv
# tile at all, and rows from Skv + window - 1 on see no key.  Such a row is 0
# in the kernel (as in the TPU kernel for a q-tile with no tile), where the
# plain version's -2e38 fill averages all of v; the rows that see a key are
# held to the plain version as everywhere.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [128, 256])
def test_flash_attention_rows_that_see_no_key(d, dtype, cuda_device):
    sq, skv, window = 512, 64, 64
    q, k, v, kw = _flash_case((1, sq, 8, 4, d, window, 50.0, True, skv), dtype, cuda_device)
    got = api.call("flash_attention", q, k, v, **kw)
    with api.dispatch_mode("ref"):
        want = api.call("flash_attention", q, k, v, **kw)
    sees = torch.arange(sq, device=cuda_device) < skv + window - 1
    _assert_kernel_close(got[:, sees], want[:, sees])
    assert bool((got[:, ~sees] == 0).all())


def test_flash_attention_refuses_what_it_does_not_take(cuda_device):
    q = torch.randn((1, 64, 4, 64), device=cuda_device)
    k = torch.randn((1, 64, 2, 64), device=cuda_device)
    wide = torch.randn((1, 64, 2, 320), device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        api.call("flash_attention", wide, wide, wide)
    with pytest.raises(ValueError, match="dtype"):
        api.call("flash_attention", q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="does not fit"):
        api.call("flash_attention", q[:, :, :3].contiguous(), k, k)
    with pytest.raises(ValueError, match="one CUDA device"):
        api.call("flash_attention", q, k.cpu(), k)


# the vector path (a warp per row, the row in registers) at Gemma-2's 2304,
# 4096 and 8192 (the register cap in 16-bit types; in fp32 past it), with
# masked lanes at d 64 and enough rows that every warp walks several; the
# scalar path at an odd d, at d 100 in 16-bit types and past the cap
RMS_SHAPES = [(7, 2304), (2, 3, 5, 512), (1, 1000), (33, 100), (5, 4096), (3, 8192),
              (9001, 64), (4, 2301), (2, 16384)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("plus_one", [False, True])
@pytest.mark.parametrize("shape", RMS_SHAPES)
def test_rms_norm_matches_plain(shape, plus_one, dtype, cuda_device):
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(shape, generator=gen).to(dtype).to(cuda_device)
    w = torch.randn(shape[-1:], generator=gen).to(cuda_device)
    api.reset_counters()
    got = api.call("rms_norm", x, w, eps=1e-6, plus_one=plus_one)
    torch.cuda.synchronize()
    assert api.launch_counts() == {"rms_norm": 1}
    with api.dispatch_mode("ref"):
        want = api.call("rms_norm", x, w, eps=1e-6, plus_one=plus_one)
    _assert_kernel_close(got, want)


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_rms_norm_offset_view(dtype, w_dtype, cuda_device):
    """A contiguous view that starts one element into its buffer (not on a
    16-byte boundary: the scalar path) and one that starts a row in (the
    vector path) give the plain version's rows."""
    gen = torch.Generator().manual_seed(10)
    rows, d = 6, 2304
    buf = torch.randn((rows + 1) * d + 1, generator=gen).to(dtype).to(cuda_device)
    w = (torch.randn(d, generator=gen) * 0.1).to(w_dtype).to(cuda_device)
    for x in (buf[1:rows * d + 1].view(rows, d), buf[d:].narrow(0, 0, rows * d).view(rows, d)):
        assert x.is_contiguous()
        got = api.call("rms_norm", x, w, eps=1e-6, plus_one=True)
        with api.dispatch_mode("ref"):
            want = api.call("rms_norm", x, w, eps=1e-6, plus_one=True)
        _assert_kernel_close(got, want)


def test_both_cuda_sources_build_side_by_side(cuda_device):
    """The CUDA sources (top_k.cu, flash_attention.cu, wkv_chunk.cu and
    rms_norm.cu) build together into build/cuda, each with its ptxas
    report; no kernel spills registers to local memory."""
    from repro_torch.kernels import _cuda

    paths = _cuda.build(["top_k", "flash_attention", "wkv_chunk", "rms_norm"])
    assert len({path.parent for path in paths.values()}) == 1
    for name in paths:
        spills = [line for line in _cuda.build_log(name).splitlines() if "spill stores" in line]
        assert spills, name
        for line in spills:
            assert re.search(r"(?<!\d)0 bytes spill stores, 0 bytes spill loads", line), line


def test_reduced_prefill_launches_one_flash_attention_per_layer(cuda_device):
    """Gemma-2 reduced (D = 32) at S = 160: the kernel path's prefill
    launches one flash_attention per layer and agrees with the plain path."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.launch.serve import make_serve_job

    cfg = dataclasses.replace(get_reduced("gemma2-2b"), attn_impl="pallas")
    job = make_serve_job(cfg, device=cuda_device, param_dtype=torch.float32)
    params = job.init_params(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 160), device=cuda_device)
    with torch.inference_mode():
        api.reset_counters()
        logits, _ = job.model.prefill(params, {"tokens": tokens}, dtype=torch.float32)
        torch.cuda.synchronize()
        assert api.launch_counts() == {"flash_attention": cfg.n_layers}
        with api.dispatch_mode("ref"):
            want, _ = job.model.prefill(params, {"tokens": tokens}, dtype=torch.float32)
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------- wkv_chunk (CUDA C++)
def _wkv_case(b, s, h, p, dtype, w_dtype, decay, device, seed=11):
    gen = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn((b, s, h, p), generator=gen).mul_(0.5).to(dtype).to(device)
               for _ in range(3))
    w = -decay * torch.exp(torch.randn((b, s, h, p), generator=gen) * 0.3)
    return r, k, v, w.to(w_dtype).to(device)


WKV_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("dtypes", WKV_DTYPES, ids=["fp32", "bf16", "bf16_fp32_logw"])
@pytest.mark.parametrize("p,chunk", [(16, 8), (32, 16), (64, 16), (64, 32), (32, 8), (64, 64)])
def test_wkv_chunk_matches_plain_chunked_form(p, chunk, dtypes, cuda_device):
    """Under strong decay (the clamp bites at chunk 16 and 32) and weak."""
    from repro_torch.kernels.wkv_chunk.ref import wkv_chunked_ref

    for decay in (0.3, 3.0):
        x = _wkv_case(2, 4 * chunk, 3, p, *dtypes, decay, cuda_device)
        api.reset_counters()
        y, state = api.call("wkv_chunk", *x, chunk=chunk)
        torch.cuda.synchronize()
        assert api.launch_counts() == {"wkv_chunk": 1}
        assert y.dtype == state.dtype == torch.float32
        y_want, s_want = wkv_chunked_ref(*x, chunk)
        torch.testing.assert_close(y, y_want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(state, s_want, rtol=1e-5, atol=1e-5)


# (P, chunk, chunks): groups of group_size(chunk) chunks with a ragged last
# group (37), many groups (300), fewer chunks than a group, odd chunk lengths
WKV_GROUP_CASES = [(64, 16, 37), (64, 16, 300), (32, 8, 300), (16, 32, 37), (64, 64, 37),
                   (64, 16, 5), (32, 5, 60), (64, 13, 11)]


@pytest.mark.parametrize("dtypes", WKV_DTYPES[1:], ids=["bf16", "bf16_fp32_logw"])
@pytest.mark.parametrize("p,chunk,n_chunks", WKV_GROUP_CASES)
def test_wkv_chunk_matches_plain_chunked_form_over_groups(p, chunk, n_chunks, dtypes,
                                                          cuda_device):
    """Long sequences cut into many groups, ragged last groups, under weak
    and strong decay, against the plain chunked form and the grouped
    carry's PyTorch mirror."""
    from repro_torch.kernels.wkv_chunk.kernel import group_size
    from repro_torch.kernels.wkv_chunk.ref import wkv_chunked_ref, wkv_grouped_ref

    for decay in (0.3, 3.0):
        x = _wkv_case(2, n_chunks * chunk, 3, p, *dtypes, decay, cuda_device, seed=13)
        y, state = api.call("wkv_chunk", *x, chunk=chunk)
        for want in (wkv_chunked_ref(*x, chunk), wkv_grouped_ref(*x, chunk, group_size(chunk))):
            torch.testing.assert_close(y, want[0], rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(state, want[1], rtol=1e-5, atol=1e-5)


def test_wkv_chunk_takes_views_at_any_offset(cuda_device):
    """Inputs that do not start on a 16-byte boundary give the same answer
    as aligned copies of them."""
    r, k, v, w = _wkv_case(1, 64, 2, 64, torch.float32, torch.float32, 1.0, cuda_device)
    buf = torch.empty(r.numel() + 1, device=cuda_device)
    buf[1:] = k.reshape(-1)
    shifted = buf[1:].view(k.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    for got, want in zip(api.call("wkv_chunk", r, shifted, v, w, chunk=16),
                         api.call("wkv_chunk", r, k, v, w, chunk=16)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtypes", WKV_DTYPES, ids=["fp32", "bf16", "bf16_fp32_logw"])
@pytest.mark.parametrize("p,chunk", [(16, 8), (32, 16), (64, 16), (64, 32)])
def test_wkv_chunk_matches_per_token_recurrence_in_the_envelope(p, chunk, dtypes, cuda_device):
    """Mild decay: no chunk's log-decay sums past -25, where the chunked
    form is the exact recurrence (the op's plain version)."""
    x = _wkv_case(1, 96, 2, p, *dtypes, 0.3, cuda_device, seed=12)
    sums = x[3].float().reshape(1, 96 // chunk, chunk, 2, p).sum(dim=2)
    assert bool((sums > -25).all())
    y, state = api.call("wkv_chunk", *x, chunk=chunk)
    with api.dispatch_mode("ref"):
        y_want, s_want = api.call("wkv_chunk", *x, chunk=chunk)
    torch.testing.assert_close(y, y_want, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(state, s_want, rtol=2e-4, atol=2e-5)


def test_wkv_chunk_refuses_what_it_does_not_take(cuda_device):
    r, k, v, w = _wkv_case(1, 64, 2, 64, torch.float32, torch.float32, 1.0, cuda_device)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        api.call("wkv_chunk", r[:, :60].contiguous(), k[:, :60].contiguous(),
                 v[:, :60].contiguous(), w[:, :60].contiguous(), chunk=16)
    with pytest.raises(ValueError, match="head size"):
        q = [t[..., :48].contiguous() for t in (r, k, v, w)]
        api.call("wkv_chunk", *q, chunk=16)
    with pytest.raises(ValueError, match="chunk"):
        api.call("wkv_chunk", r, k, v, w, chunk=128)
    with pytest.raises(ValueError, match="one CUDA device"):
        api.call("wkv_chunk", r, k.cpu(), v, w, chunk=16)
    with pytest.raises(ValueError, match="dtype"):
        api.call("wkv_chunk", r, k, v, w.to(torch.bfloat16), chunk=16)
    with pytest.raises(ValueError, match="dtype"):
        api.call("wkv_chunk", r.half(), k.half(), v.half(), w, chunk=16)
    # the op's adapter makes strided views contiguous: the same answer
    strided = k.transpose(1, 2).contiguous().transpose(1, 2)
    assert not strided.is_contiguous()
    for got, want in zip(api.call("wkv_chunk", r, strided, v, w, chunk=16),
                         api.call("wkv_chunk", r, k, v, w, chunk=16)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="shape"):
        api.call("wkv_chunk", r, k[:, :32].contiguous(), v, w, chunk=16)


def test_reduced_rwkv_prefill_launches_one_wkv_chunk_per_layer(cuda_device):
    """RWKV-6 3B reduced at S = 64: the kernel path's prefill launches one
    wkv_chunk per layer and agrees with the plain chunked path."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.launch.serve import make_serve_job
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_reduced("rwkv6-3b"), rwkv_chunk=16, rwkv_pallas=True)
    job = make_serve_job(cfg, device=cuda_device, param_dtype=torch.float32)
    params = job.init_params(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda_device)
    twin = Model(dataclasses.replace(cfg, rwkv_pallas=False))
    with torch.inference_mode():
        api.reset_counters()
        logits, caches = job.model.prefill(params, {"tokens": tokens}, dtype=torch.float32)
        torch.cuda.synchronize()
        assert api.launch_counts() == {"wkv_chunk": cfg.n_layers}
        want, want_caches = twin.prefill(params, {"tokens": tokens}, dtype=torch.float32)
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(caches["b0"]["rwkv"]["wkv"], want_caches["b0"]["rwkv"]["wkv"],
                               rtol=1e-4, atol=1e-4)


# ----------------------------------------------- telemetry and checkpoints
def test_spans_on_and_off_are_bit_for_bit_and_fold_launches(cuda_device):
    """CHOCO top-k DSE-MVR through the kernels: a hub with spans on or off
    changes no bit of the run and no launch, and the hub's
    ``kernel_launches`` totals are the run's launch counts."""
    from repro_torch.telemetry import Telemetry

    idx = torch.randint(0, 177, (32, N_NODES, BATCH), device=cuda_device,
                        generator=torch.Generator(device=cuda_device).manual_seed(0))
    runs = {}
    for mode in ("none", "off", "on"):
        hub = None if mode == "none" else Telemetry(spans=mode == "on")
        api.reset_counters()
        out = tproblem.run_method("dse_mvr", 0.5, TAU, BATCH, 32, device=cuda_device,
                                  use_fused=True, channel="choco", compression="top_k:0.1",
                                  keep_state=True, telemetry=hub, index_fn=lambda s: idx[s])
        runs[mode] = (out, api.launch_counts(), hub)
    base, launches, _ = runs["none"]
    assert launches["top_k_pack"] == launches["top_k_unpack"] == 8 * 32 // TAU, launches
    for mode in ("off", "on"):
        out, got, hub = runs[mode]
        assert got == launches, mode
        for k, t in base["state"].params.items():
            assert torch.equal(out["state"].params[k], t), (mode, k)
        folded = {op: hub.total("kernel_launches", op) for op in hub.labels("kernel_launches")}
        assert folded == {op: float(n) for op, n in launches.items()}, mode
    assert {"local", "gossip", "eval"} <= set(runs["on"][2].labels("span_seconds"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_round_trip_on_the_card(dtype, tmp_path, cuda_device):
    """Leaves saved from the card come back onto it with their dtype and
    bits (bf16 through its raw 16-bit words)."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    tree = {"w": torch.randn(257, 33, generator=gen, device=cuda_device).to(dtype),
            "b": {"x": torch.randn(5, generator=gen, device=cuda_device).to(dtype)}, "n": 7}
    save_checkpoint(str(tmp_path), 4, tree)
    for like in (tree, None):
        got, _ = load_checkpoint(str(tmp_path), like=like)
        for a, b in ((got["w"], tree["w"]), (got["b"]["x"], tree["b"]["x"])):
            assert a.is_cuda and a.dtype == dtype and torch.equal(a, b)
    assert got["n"].item() == 7 and load_checkpoint(str(tmp_path), like=tree)[0]["n"] == 7


# ------------------------------------------------- gradients through the kernels
def test_flash_attention_gradient_through_the_kernel(cuda_device):
    """With inputs that require grad, the forward is the kernel's launch,
    bit for bit its no-grad output, and the backward (the plain version's
    gradient, recomputed) launches nothing: the gradients equal those of
    the plain forward's graph bit for bit."""
    q, k, v, kw = _flash_case((2, 300, 8, 4, 128, None, None, True), torch.float32, cuda_device)
    with torch.no_grad():
        plain_out = api.call("flash_attention", q, k, v, **kw)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    api.reset_counters()
    out = api.call("flash_attention", *qkv, **kw)
    ct = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(3),
                     device="cuda")
    grads = torch.autograd.grad(out, qkv, ct)
    torch.cuda.synchronize()
    assert api.launch_counts() == {"flash_attention": 1}
    assert torch.equal(out.detach(), plain_out)
    with api.dispatch_mode("ref"):
        want = torch.autograd.grad(api.call("flash_attention", *qkv, **kw), qkv, ct)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", ["axpby", "mvr_update"])
def test_elementwise_gradient_through_the_kernels(name, cuda_device):
    """One launch a dtype bucket in the forward, none in the backward, and
    the gradients of the plain version on the CPU."""
    scalars, makers = OPS[name]
    gen = torch.Generator().manual_seed(4)
    trees = [{k: make(gen, shape, dt) for k, (shape, dt) in LEAVES.items()} for make in makers]
    cuda = [{k: v.to(cuda_device).requires_grad_() for k, v in t.items()} for t in trees]
    cpu = [{k: v.clone().requires_grad_() for k, v in t.items()} for t in trees]
    api.reset_counters()
    out = api.call(name, *cuda, scalars=scalars)
    grads = torch.autograd.grad([out[k].float().sum() for k in LEAVES],
                                [t[k] for t in cuda for k in LEAVES])
    torch.cuda.synchronize()
    assert api.launch_counts() == {name: 2}   # the fp32 and the bf16 bucket
    want_out = api.call(name, *cpu, scalars=scalars)
    want = torch.autograd.grad([want_out[k].float().sum() for k in LEAVES],
                               [t[k] for t in cpu for k in LEAVES])
    for g, w in zip(grads, want):
        _assert_kernel_close(g.cpu(), w, rtol=1e-6, atol=1e-6)


def test_reduced_vision_loss_gradient_through_the_kernel(cuda_device):
    """The reduced Qwen2-VL's loss (fp32) differentiated on the card: one
    flash launch a layer in the forward, none in the backward, and each
    parameter's gradient within 1e-4 of its largest |gradient| of the
    plain forward's."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.models import Model
    from repro_torch.tree import tree_flatten

    cfg = dataclasses.replace(get_reduced("qwen2-vl-2b"), attn_impl="pallas")
    model = Model(cfg)
    params = model.init(0, device=cuda_device)
    leaves, _ = tree_flatten(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    text = 112
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, text), generator=gen, device="cuda"),
             "vision_embeds": torch.randn((2, cfg.n_vision_tokens, cfg.d_model), generator=gen,
                                          device="cuda"),
             "targets": torch.randint(0, cfg.vocab_size, (2, text), generator=gen, device="cuda")}
    api.reset_counters()
    grads = torch.autograd.grad(model.loss(params, batch, dtype=torch.float32), leaves)
    torch.cuda.synchronize()
    assert api.launch_counts() == {"flash_attention": cfg.n_layers}
    with api.dispatch_mode("ref"):
        want = torch.autograd.grad(model.loss(params, batch, dtype=torch.float32), leaves)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * float(w.abs().max()))
