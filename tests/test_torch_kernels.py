"""The port's fused-op backend (``repro_torch.kernels.api``) against the
reference's (``repro.kernels.api``).

For each of the seven ported elementwise ops, on an odd-size tree that mixes fp32 and
bf16 leaves, made with numpy from a seed and fed to both packages (the QSGD
ops get inputs in their domain: a normalized buffer and U[0, 1) noise for
the quantize, an int8 payload and a positive scale for the dequantize):

  * the port's plain version (what a CPU tensor runs) vs the reference's
    per-leaf ``ref_fn`` and vs its Pallas kernel in interpret mode;
  * one dispatch per dtype bucket, as the reference counts them;
  * the same ``ValueError``s as the reference on malformed calls.

Tolerances: fp32 rtol 1e-6 / atol 1e-7 -- both sides compute the same fp32
expression, XLA and ATen may order or contract it differently by an ulp.
bf16 within one bf16 ulp -- each side rounds its fp32 value once.  The
QSGD ops are held exactly: their levels are integers, and neither side
contracts the quantize's multiply-add.  On a CUDA card (marker ``cuda``)
each Triton kernel is held to the plain version.

The two shaped ops, ``top_k_pack`` and ``top_k_unpack``, are held exactly to
the reference's ``ref_fn`` and to its Pallas kernels in interpret mode, on
the reference's own case (odd d = 777, 13 indices per row; distinct indices
for the unpack): a gather copies, and with distinct indices every unpacked
slot is one value added to zero.  With duplicate indices the unpack sums in
another order, so it is held within fp32 rtol 1e-6 there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401  (populates the reference registry)
from repro.kernels import api as japi
from repro_torch.convert import tree_to_numpy
from repro_torch.kernels import _cuda
from repro_torch.kernels import api as tapi


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _unit(rng, shape):          # a node-normalized buffer, |x| <= 1
    return rng.uniform(-1.0, 1.0, shape).astype(np.float32)


def _uniform01(rng, shape):     # the quantize's noise
    return rng.random(shape, dtype=np.float32)


def _levels(rng, shape):        # the int8 QSGD payload
    return rng.integers(-127, 128, shape).astype(np.int8)


def _positive(rng, shape):      # the per-node scale, broadcast
    return rng.uniform(0.1, 2.0, shape).astype(np.float32)


# op -> (scalars, one input maker per input)
OPS = {
    "mvr_update": ((0.05,), (_normal,) * 3),
    "axpby": ((-0.3, 1.0), (_normal,) * 2),
    "add_sub": ((), (_normal,) * 3),
    "dse_combine": ((0.3,), (_normal,) * 4),
    "dse_combine_yh": ((0.3,), (_normal,) * 5),
    "qsgd_quantize": ((127.0,), (_unit, _uniform01)),
    "qsgd_dequantize": ((1.0 / 127,), (_levels, _positive)),
}
# odd sizes (ragged tails), a 0-d leaf, and two dtype buckets
LEAVES = {
    "a": ((3, 7), "float32"),
    "b": ((1001,), "bfloat16"),
    "c": ((5, 13), "float32"),
    "d": ((), "float32"),
    "e": ((2, 3, 5), "bfloat16"),
}
TOL32 = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Triton kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _numpy_trees(name, seed):
    """One numpy tree per input of ``name``, from its input makers."""
    rng = np.random.default_rng(seed)
    return [{k: make(rng, shape) for k, (shape, _) in LEAVES.items()} for make in OPS[name][1]]


def _dtype(k, v):
    """A leaf's dtype name: int8 payloads stay int8, floats take LEAVES'."""
    return "int8" if v.dtype == np.int8 else LEAVES[k][1]


def _jax_tree(tree):
    return {k: jnp.asarray(v).astype(_dtype(k, v)) for k, v in tree.items()}


def _torch_tree(tree, device="cpu"):
    return {k: torch.from_numpy(v).to(device, getattr(torch, _dtype(k, v)))
            for k, v in tree.items()}


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significand bits)."""
    _, e = np.frexp(np.abs(x).astype(np.float32))
    return np.ldexp(np.float32(1.0), e - 8)


def _assert_close(got, want, dtype_name, exact=False):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if exact:
        np.testing.assert_array_equal(got, want)
    elif dtype_name == "bfloat16":
        ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
        assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want) / ulp)
    else:
        np.testing.assert_allclose(got, want, **TOL32)


def _assert_trees_close(got_trees, want_trees, exact=False):
    for g_tree, w_tree in zip(got_trees, want_trees):
        for k in LEAVES:
            _assert_close(g_tree[k], w_tree[k], LEAVES[k][1], exact=exact)


def _exact(name):
    return name.startswith("qsgd")


@pytest.mark.parametrize("name", sorted(OPS))
def test_plain_matches_reference_ref(name):
    scalars = OPS[name][0]
    np_trees = _numpy_trees(name, seed=len(name))
    assert len(np_trees) == japi.get(name).n_inputs
    got = _as_tuple(tapi.tree_apply(name, *map(_torch_tree, np_trees), scalars=scalars))
    jtrees = list(map(_jax_tree, np_trees))
    ref_fn = japi.get(name).ref_fn
    want = {k: _as_tuple(ref_fn(*(t[k] for t in jtrees), *scalars)) for k in LEAVES}
    want_trees = [{k: np.asarray(want[k][j].astype(jnp.float32)) for k in LEAVES}
                  for j in range(len(got))]
    for g_tree in got:
        for k in LEAVES:
            assert str(g_tree[k].dtype) == f"torch.{LEAVES[k][1]}"
    _assert_trees_close(map(tree_to_numpy, got), want_trees, exact=_exact(name))


@pytest.mark.parametrize("name", sorted(OPS))
def test_plain_matches_reference_interpret_kernel(name):
    scalars = OPS[name][0]
    np_trees = _numpy_trees(name, seed=7 + len(name))
    got = _as_tuple(tapi.tree_apply(name, *map(_torch_tree, np_trees), scalars=scalars))
    with japi.dispatch_mode("interpret"):
        want = _as_tuple(japi.tree_apply(name, *map(_jax_tree, np_trees), scalars=scalars))
    want = [jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), w) for w in want]
    _assert_trees_close(map(tree_to_numpy, got), want, exact=_exact(name))


@pytest.mark.parametrize("name", sorted(OPS))
def test_one_dispatch_per_dtype_bucket(name):
    scalars = OPS[name][0]
    np_trees = _numpy_trees(name, seed=1)
    tapi.reset_counters()
    tapi.tree_apply(name, *map(_torch_tree, np_trees), scalars=scalars)
    japi.reset_counters()
    with japi.dispatch_mode("interpret"):
        japi.tree_apply(name, *map(_jax_tree, np_trees), scalars=scalars)
    # fp32 and bf16 buckets: two dispatches on each side, no launch on the CPU
    assert tapi.call_counts() == {name: 2} == japi.call_counts()
    assert tapi.launch_counts() == {}


def test_call_matches_reference_call():
    """``api.call`` on bare tensors: one dispatch, the reference's result."""
    rng = np.random.default_rng(5)
    a, b, c = (rng.standard_normal((4, 9)).astype(np.float32) for _ in range(3))
    tapi.reset_counters()
    got = tapi.call("add_sub", *map(torch.from_numpy, (a, b, c)))
    assert tapi.call_counts() == {"add_sub": 1}
    want = japi.call("add_sub", *map(jnp.asarray, (a, b, c)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)
    q = tapi.call("qsgd_quantize", torch.from_numpy(a / np.abs(a).max()),
                  torch.from_numpy(_uniform01(rng, a.shape)), scalars=(127.0,))
    assert q.shape == a.shape and float(q.abs().max()) <= 127.0


def test_like_sets_output_dtype():
    rng = np.random.default_rng(3)
    np_x, np_y = ({k: _normal(rng, shape) for k, (shape, _) in LEAVES.items()}
                  for _ in range(2))
    like = {k: np.zeros(LEAVES[k][0], np.float32) for k in LEAVES}
    # fp32 inputs everywhere, bf16 outputs where LEAVES says bf16
    x32 = {k: torch.from_numpy(v) for k, v in np_x.items()}
    y32 = {k: torch.from_numpy(v) for k, v in np_y.items()}
    got = tapi.tree_axpby(-0.3, x32, 1.0, y32, like=_torch_tree(like))
    want = japi.tree_axpby(-0.3, {k: jnp.asarray(v) for k, v in np_x.items()}, 1.0,
                           {k: jnp.asarray(v) for k, v in np_y.items()},
                           like=_jax_tree(like))
    for k in LEAVES:
        assert str(got[k].dtype) == f"torch.{LEAVES[k][1]}"
    _assert_trees_close([tree_to_numpy(got)],
                        [jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), want)])


def _bad_calls(lib, tree):
    """Malformed calls, each of which the reference rejects."""
    t = tree(np.ones(3, np.float32))
    other = tree(np.ones(4, np.float32))
    extra = dict(t, extra=t["x"])
    return {
        "n_trees": lambda: lib.tree_apply("axpby", t, scalars=(1.0, 1.0)),
        "n_scalars": lambda: lib.tree_apply("axpby", t, t, scalars=(1.0,)),
        "structure": lambda: lib.tree_apply("axpby", t, extra, scalars=(1.0, 1.0)),
        "leaf_shape": lambda: lib.tree_apply("axpby", t, other, scalars=(1.0, 1.0)),
        "like_two_outputs": lambda: lib.tree_apply(
            "dse_combine", t, t, t, t, scalars=(0.1,), like=t),
        "like_structure": lambda: lib.tree_apply(
            "axpby", t, t, scalars=(1.0, 1.0), like=extra),
        "unknown_op": lambda: lib.tree_apply("no_such_op", t),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls(tapi, lambda a: {"x": a})))
def test_same_value_errors_as_reference(case):
    with pytest.raises(ValueError):
        _bad_calls(japi, lambda a: {"x": jnp.asarray(a)})[case]()
    with pytest.raises(ValueError):
        _bad_calls(tapi, lambda a: {"x": torch.from_numpy(a)})[case]()


def test_no_fallback_off_cpu_and_cuda():
    """A tensor on a device with no kernel raises instead of running the
    plain version (the port's rule: only CPU tensors take it)."""
    t = {"x": torch.ones(5, device="meta")}
    with pytest.raises(ValueError, match="no kernel"):
        tapi.tree_axpby(1.0, t, 1.0, t)


def test_refuses_inputs_that_require_grad():
    """Inputs that require grad are taken now: the op's gradient is its
    plain version's (a for x, b for y), and the backward dispatches
    nothing."""
    x = {"x": torch.ones(4, requires_grad=True)}
    y = {"x": torch.full((4,), 2.0, requires_grad=True)}
    tapi.reset_counters()
    out = tapi.tree_axpby(0.5, x, -3.0, y)
    torch.testing.assert_close(out["x"], torch.full((4,), -5.5))
    gx, gy = torch.autograd.grad(out["x"].sum(), (x["x"], y["x"]))
    torch.testing.assert_close(gx, torch.full((4,), 0.5))
    torch.testing.assert_close(gy, torch.full((4,), -3.0))
    assert tapi.call_counts() == {"axpby": 1} and tapi.launch_counts() == {}


def test_dispatch_mode_validates_and_restores():
    with pytest.raises(ValueError):
        with tapi.dispatch_mode("interpret"):
            pass
    with tapi.dispatch_mode("ref"):
        assert tapi._mode == "ref"
    assert tapi._mode == "kernel"


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(OPS))
def test_kernel_matches_plain_on_cuda(name, cuda_device):
    """Triton kernel vs its plain version on the card: fp32 within FMA
    contraction (rtol 1e-6, atol 1e-6); bf16 within one bf16 ulp beyond it;
    the QSGD ops exactly (the quantize is built without FMA contraction)."""
    scalars = OPS[name][0]
    np_trees = _numpy_trees(name, seed=11)
    trees = [_torch_tree(t, cuda_device) for t in np_trees]
    tapi.reset_counters()
    got = _as_tuple(tapi.tree_apply(name, *trees, scalars=scalars))
    assert tapi.launch_counts() == {name: 2}
    with tapi.dispatch_mode("ref"):
        want = _as_tuple(tapi.tree_apply(name, *trees, scalars=scalars))
    for g_tree, w_tree in zip(got, want):
        for k in LEAVES:
            g, w = g_tree[k].float().cpu().numpy(), w_tree[k].float().cpu().numpy()
            if _exact(name):
                np.testing.assert_array_equal(g, w)
            elif LEAVES[k][1] == "bfloat16":
                excess = np.maximum(np.abs(g - w) - 1e-6, 0)
                assert np.all(excess <= _bf16_ulp(np.maximum(np.abs(g), np.abs(w))))
            else:
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------- shaped ops
def _top_k_case(dtype):
    """The reference's pack/unpack case: x (3, 777), 13 indices per row drawn
    with replacement, and 13 distinct ones per row for the unpack."""
    key = jax.random.key(11)
    x = np.array(jax.random.normal(key, (3, 777)))
    idx = np.array(jax.random.randint(jax.random.fold_in(key, 1), (3, 13), 0, 777), np.int32)
    rng = np.random.default_rng(11)
    distinct = np.stack([rng.choice(777, 13, replace=False) for _ in range(3)]).astype(np.int32)
    jx = jnp.asarray(x).astype(dtype)
    return jx, np.asarray(jx.astype(jnp.float32)), idx, distinct


def _torch_from(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["with_repeats", "distinct"])
def test_top_k_pack_matches_reference(dtype, which):
    jx, x, idx, distinct = _top_k_case(dtype)
    ix = idx if which == "with_repeats" else distinct
    tapi.reset_counters()
    got = tapi.call("top_k_pack", _torch_from(x, dtype), torch.from_numpy(ix))
    assert tapi.call_counts() == {"top_k_pack": 1} and tapi.launch_counts() == {}
    assert str(got.dtype) == f"torch.{dtype}" and tuple(got.shape) == (3, 13)
    want_ref = japi.get("top_k_pack").ref_fn(jx, jnp.asarray(ix))
    with japi.dispatch_mode("interpret"):
        want_kernel = japi.call("top_k_pack", jx, jnp.asarray(ix))
    for want in (want_ref, want_kernel):
        np.testing.assert_array_equal(tree_to_numpy(got), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_top_k_unpack_matches_reference(dtype):
    jx, x, _, distinct = _top_k_case(dtype)
    jvals = japi.get("top_k_pack").ref_fn(jx, jnp.asarray(distinct))
    vals = _torch_from(np.asarray(jvals.astype(jnp.float32)), dtype)
    tapi.reset_counters()
    got = tapi.call("top_k_unpack", torch.from_numpy(distinct), vals, d=777)
    assert tapi.call_counts() == {"top_k_unpack": 1} and tapi.launch_counts() == {}
    assert str(got.dtype) == f"torch.{dtype}" and tuple(got.shape) == (3, 777)
    want_ref = japi.get("top_k_unpack").ref_fn(jnp.asarray(distinct), jvals, 777)
    with japi.dispatch_mode("interpret"):
        want_kernel = japi.call("top_k_unpack", jnp.asarray(distinct), jvals, d=777)
    for want in (want_ref, want_kernel):
        np.testing.assert_array_equal(tree_to_numpy(got), np.asarray(want.astype(jnp.float32)))
    # the round trip puts every kept value back in its place, zeros elsewhere
    dense = np.zeros_like(x)
    np.put_along_axis(dense, distinct, np.take_along_axis(x, distinct, 1), 1)
    np.testing.assert_array_equal(tree_to_numpy(got), dense)


def test_top_k_unpack_with_repeated_indices_sums_them():
    jx, x, idx, _ = _top_k_case("float32")
    vals = np.take_along_axis(x, idx, 1)
    got = tapi.call("top_k_unpack", torch.from_numpy(idx), torch.from_numpy(vals), d=777)
    with japi.dispatch_mode("interpret"):
        want = japi.call("top_k_unpack", jnp.asarray(idx), jnp.asarray(vals), d=777)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_shaped_ops_follow_the_dispatch_rules():
    x = torch.randn(2, 9)
    idx = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="shaped op"):
        tapi.tree_apply("top_k_pack", x, idx)
    with pytest.raises(ValueError, match="scalars"):
        tapi.call("top_k_pack", x, idx, scalars=(1.0,))
    with pytest.raises(ValueError, match="expected 2"):
        tapi.call("top_k_pack", x)
    # differentiable in x (a scatter of the cotangent), not in the indices
    xg = x.clone().requires_grad_(True)
    (gx,) = torch.autograd.grad(tapi.call("top_k_pack", xg, idx).sum(), (xg,))
    torch.testing.assert_close(gx, torch.zeros_like(x).index_fill_(1, torch.tensor([0]), 3.0))
    with pytest.raises(ValueError, match="no kernel"):
        tapi.call("top_k_pack", torch.ones((2, 9), device="meta"),
                  torch.zeros((2, 3), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="exactly one"):
        tapi.FusedOp(name="neither", ref_fn=lambda x: x, n_inputs=1)
    for name in ("top_k_pack", "top_k_unpack"):
        assert not tapi.get(name).elementwise and japi.get(name).kernel_fn is not None


def test_cuda_loader_raises_without_nvcc(monkeypatch, tmp_path):
    """Nothing is built at import; the first launch builds, and with no
    ``nvcc`` anywhere it raises a ``RuntimeError`` that says so."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_cuda, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cuda, "_loaded", {})
    with pytest.raises(RuntimeError, match="no nvcc"):
        _cuda.find_nvcc()
    with pytest.raises(RuntimeError, match="no nvcc"):
        _cuda.library("top_k", {})
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").iterdir())
