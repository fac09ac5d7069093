"""The port's attention and RMSNorm ops against the reference's, on the CPU.

The same numpy inputs, made from a seed, go to both packages:

  * the port's plain ``flash_attention`` (what a CPU tensor runs, and the
    yardstick of the CUDA kernel on the card) against the reference's
    ``flash_attention_ref`` and against its Pallas kernel in interpret mode
    (32-row tiles, so the tile skipping of causal and windowed rows is
    exercised at S = 128 and 256); lengths that are no multiple of 128
    against the reference's plain version only, because the Pallas kernel
    asserts S % 128 == 0;
  * the zero padding by which the CUDA wrapper runs a head dim between its
    instances (Zamba2's 112 on the 128 instance, 48 on 64): the plain
    version on the padded q, k and v, with q scaled so that the scores keep
    the true head dim's 1/sqrt(D), is the reference's attention at the
    true D in the first D columns and zero after;
  * the port's plain ``rms_norm`` against ``rms_norm_ref`` and the Pallas
    kernel (through the reference's row-padding ops), odd row counts and
    Gemma-2's width of 2304 included;
  * the port's ``attention_forward`` with each ``attn_impl`` against the
    reference's, on the same parameters.

Tolerances: fp32 rtol 1e-5 / atol 1e-5 -- both sides compute in fp32 and sum
in another order (ATen's GEMM, XLA's dot, the interpret kernel's online
softmax).  bf16 inputs: both sides compute in fp32 and round the output
once, so one bf16 ulp beyond the fp32 tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401  (populates the reference registry)
from repro.kernels import api as japi
from repro.kernels.flash_attention import flash_attention_ref as j_flash_ref
from repro.kernels.flash_attention.kernel import flash_attention_fwd as j_flash_fwd
from repro.kernels.rms_norm import rms_norm_ref as j_rms_ref
from repro.models import attention as jattn
from repro.models.common import Initializer as JInitializer
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import api as tapi
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.flash_attention.kernel import kernel_head_dim
from repro_torch.kernels.rms_norm import rms_norm_ref
from repro_torch.models import attention as tattn

RTOL = ATOL = 1e-5
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}

# (b, s, h, kh, d, window, softcap, causal): GQA 1 / 2 / 4, D 32 / 64,
# window None / 16 / 48, softcap None / 50, causal and bidirectional
FLASH_CASES = [
    (2, 128, 2, 2, 32, None, None, True),
    (2, 128, 4, 2, 64, None, None, True),
    (1, 128, 4, 1, 32, None, None, True),
    (1, 128, 4, 2, 64, 16, None, True),
    (1, 128, 4, 2, 32, 48, 50.0, True),
    (1, 128, 8, 2, 64, None, 50.0, True),
    (1, 128, 2, 2, 32, None, None, False),
    (1, 128, 4, 1, 64, 16, 50.0, True),
    (2, 256, 4, 2, 32, 48, 50.0, True),
    (1, 128, 4, 2, 64, 48, 50.0, False),
]
RAGGED_CASES = [
    (1, 100, 4, 2, 32, 16, 50.0, True),
    (2, 77, 8, 2, 64, None, None, True),
]


def _both(a: np.ndarray, dtype: str):
    """One numpy array as a reference array and a port tensor with the same
    bits (bf16 rounded once, by the reference)."""
    jd, _ = DTYPES[dtype]
    j = jnp.asarray(a).astype(jd)
    return j, params_from_numpy(np.asarray(j), "cpu")


def _assert_close(got: torch.Tensor, want, dtype: str):
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    tol = ATOL + RTOL * np.abs(w)
    if dtype == "bf16":
        _, e = np.frexp(np.maximum(np.abs(g), np.abs(w)))
        tol = tol + np.ldexp(1.0, e - 8)   # one bf16 ulp (8 significand bits)
    err = np.abs(g - w)
    assert np.all(err <= tol), f"max excess {np.max(err - tol)}"


def _qkv(case, dtype, seed=0):
    b, s, h, kh, d = case[:5]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32) * 4   # softcap bites
    k = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    return [_both(x, dtype) for x in (q, k, v)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_plain_matches_reference(case, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(case, dtype)
    window, softcap, causal = case[5:]
    got = flash_attention_ref(tq, tk, tv, causal=causal, sliding_window=window, softcap=softcap)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = j_flash_ref(jq, jk, jv, causal=causal, sliding_window=window, softcap=softcap)
    _assert_close(got, want, dtype)
    kernel = j_flash_fwd(jq.swapaxes(1, 2), jk.swapaxes(1, 2), jv.swapaxes(1, 2),
                         causal=causal, sliding_window=window, softcap=softcap,
                         block_q=32, block_k=32, interpret=True).swapaxes(1, 2)
    _assert_close(got, kernel, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", RAGGED_CASES)
def test_flash_attention_plain_matches_reference_at_ragged_lengths(case, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(case, dtype, seed=1)
    window, softcap, causal = case[5:]
    got = tapi.call("flash_attention", tq, tk, tv,
                    causal=causal, sliding_window=window, softcap=softcap)
    want = j_flash_ref(jq, jk, jv, causal=causal, sliding_window=window, softcap=softcap)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("case", [(1, 128, 4, 4, 112, None, None, True),
                                  (2, 128, 4, 2, 112, 48, 50.0, True),
                                  (1, 128, 4, 2, 48, None, None, True)])
def test_padded_head_dim_is_the_unpadded_attention(case):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(case, "fp32", seed=3)
    window, softcap, causal = case[5:]
    d = case[4]
    dk = kernel_head_dim(d)
    assert dk == {112: 128, 48: 64}[d]
    pad = [torch.nn.functional.pad(t, (0, dk - d)) for t in (tq, tk, tv)]
    pad[0] = pad[0] * (dk / d) ** 0.5   # the wrapper passes 1/sqrt(d) instead
    got = flash_attention_ref(*pad, causal=causal, sliding_window=window, softcap=softcap)
    want = j_flash_ref(jq, jk, jv, causal=causal, sliding_window=window, softcap=softcap)
    _assert_close(got[..., :d], want, "fp32")
    assert bool((got[..., d:] == 0).all())
    for bad in (0, 257):
        with pytest.raises(ValueError, match="head_dim"):
            kernel_head_dim(bad)


def test_flash_attention_rows_see_only_their_window():
    """A query's output depends on exactly the keys its mask admits: with a
    window of 8, row 63 sees keys 56..63 and row 56 keys 49..56, so changing
    keys 0..55 leaves row 63 and moves row 56."""
    (_, tq), (_, tk), (_, tv) = _qkv((1, 64, 2, 1, 32), "fp32", seed=2)
    out = flash_attention_ref(tq, tk, tv, causal=True, sliding_window=8)
    tk2, tv2 = tk.clone(), tv.clone()
    tk2[:, :56] += 1.0
    tv2[:, :56] -= 1.0
    out2 = flash_attention_ref(tq, tk2, tv2, causal=True, sliding_window=8)
    assert torch.equal(out[:, 63], out2[:, 63])
    assert not torch.equal(out[:, 56], out2[:, 56])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("plus_one", [False, True])
@pytest.mark.parametrize("shape", [(8, 128), (2, 64, 256), (1, 3, 5, 512), (7, 2304)])
def test_rms_norm_plain_matches_reference(shape, plus_one, dtype):
    rng = np.random.default_rng(3)
    jx, tx = _both(rng.standard_normal(shape).astype(np.float32), dtype)
    jw, tw = _both(rng.standard_normal(shape[-1:]).astype(np.float32), "fp32")
    got = rms_norm_ref(tx, tw, 1e-6, plus_one)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _assert_close(got, j_rms_ref(jx, jw, 1e-6, plus_one), dtype)
    with japi.dispatch_mode("interpret"):
        kernel = japi.call("rms_norm", jx, jw, eps=1e-6, plus_one=plus_one)
    _assert_close(got, kernel, dtype)


def test_shaped_ops_on_cpu_count_calls_and_no_launches():
    tq = torch.randn(1, 16, 2, 32)
    tapi.reset_counters()
    tapi.call("flash_attention", tq, tq, tq, causal=True)
    tapi.call("rms_norm", tq, torch.ones(32), eps=1e-6, plus_one=True)
    assert tapi.call_counts() == {"flash_attention": 1, "rms_norm": 1}
    assert tapi.launch_counts() == {}
    # an input that requires grad: the same one call and no launch, and the
    # plain version's gradient
    tw = torch.ones(32, requires_grad=True)
    y = tapi.call("rms_norm", tq.requires_grad_(), tw, eps=1e-6, plus_one=True)
    gx, gw = torch.autograd.grad(y.square().sum(), (tq, tw))
    want = torch.autograd.grad(rms_norm_ref(tq, tw, 1e-6, plus_one=True).square().sum(), (tq, tw))
    torch.testing.assert_close((gx, gw), want, rtol=1e-6, atol=1e-6)
    assert tapi.call_counts() == {"flash_attention": 1, "rms_norm": 2}
    assert tapi.launch_counts() == {}
    for name in ("flash_attention", "rms_norm"):
        assert not tapi.get(name).elementwise and japi.get(name).kernel_fn is not None


@pytest.mark.parametrize("impl", ["xla", "blockwise", "pallas"])
def test_attention_forward_matches_reference(impl):
    """One Gemma-2-like local layer (GQA, window, softcap): the port's
    attention_forward with each impl against the reference's, on the
    reference's parameters; the prefill cache comes back too."""
    kw = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=32, sliding_window=16,
              attn_softcap=50.0, attn_impl=impl)
    jcfg = jattn.AttentionConfig(**kw)
    tcfg = tattn.AttentionConfig(**kw)
    jp = jattn.init_attention(jcfg, JInitializer("params", jax.random.key(4)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(5).standard_normal((2, 128, 64)).astype(np.float32)
    pos = np.ascontiguousarray(np.broadcast_to(np.arange(128, dtype=np.int32), (2, 128)))
    with japi.dispatch_mode("interpret"):
        jy, jc = jattn.attention_forward(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                                         return_cache=True)
    ty, tc = tattn.attention_forward(tcfg, tp, torch.from_numpy(x), torch.from_numpy(pos),
                                     return_cache=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
