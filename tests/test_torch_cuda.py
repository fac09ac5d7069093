"""The port's Triton kernels and launch counts on a CUDA card.

Every test here carries the ``cuda`` marker and skips without a card.  The
file imports neither JAX nor ``repro``, so it runs on a machine with torch,
Triton and a card alone:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances, kernel vs its plain version on the same card: fp32 rtol 1e-6 /
atol 1e-6 (Triton may contract a multiply-add into an FMA, one ulp); bf16
within one bf16 ulp beyond that; the QSGD ops exactly (integer levels, and
the quantize is built without FMA contraction).
"""
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
        pytest.skip("needs a CUDA device: the Triton kernels run only on the card")
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


def _bf16_ulp(x):
    _, e = torch.frexp(x.abs())
    return torch.ldexp(torch.ones_like(x), e - 8)


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
                assert bool(torch.all(excess <= _bf16_ulp(torch.maximum(g.abs(), w.abs()))))
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
