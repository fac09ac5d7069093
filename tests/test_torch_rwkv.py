"""The port's RWKV-6 block and wkv recurrences against the reference's, on
the CPU.

Inputs are made with numpy from a seed and given to both sides; the
reference runs its plain versions, and its Pallas wkv kernel in interpret
mode.

  * ``wkv_ref`` (the per-token recurrence, the op's plain version) against
    the reference's, with and without an initial state: rtol 1e-5 / atol
    1e-6 (fp32, one order of operations);
  * the plain chunked form against the reference's ``_chunked_wkv`` and
    against its Pallas kernel in interpret mode, under weak (|logw| ~ 1)
    and strong (|logw| ~ 3, where a 16-token chunk's decay passes the -25
    clamp) decay: rtol 1e-5 / atol 1e-5.  This pins down the clamp
    semantics the CUDA kernel follows.  With ``chunk_bf16`` the operands
    are rounded to bf16 before each product: an exponential that differs by
    an fp32 ulp between XLA and ATen then rounds to the neighbouring bf16
    value, so that case is held within 2^-7 of the largest |y| (about two
    bf16 roundings of a term);
  * ``timemix_forward`` in its three branches and ``chanmix_forward``; the
    kernel branch (the op's plain version, the exact recurrence, on the
    CPU) against the reference's Pallas kernel inside the clamp envelope,
    within the reference's own 2e-4 (``tests/test_model_units.py``);
  * 16 decode steps reproduce the forward pass's outputs and cache.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import api as japi
from repro.kernels.wkv_chunk.kernel import wkv_chunk_fwd as j_wkv_kernel
from repro.kernels.wkv_chunk.ref import wkv_ref as j_wkv_ref
from repro.models import rwkv as jr
from repro.models.common import Initializer as JInitializer
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import api
from repro_torch.kernels.wkv_chunk.ref import wkv_ref
from repro_torch.models import rwkv as tr

TIGHT = dict(rtol=1e-5, atol=1e-5)
KERNEL_BRANCH = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _wkv_inputs(seed, b, s, h, p, decay):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, p)).astype(np.float32) * 0.5 for _ in range(3))
    logw = (-decay * np.exp(rng.standard_normal((b, s, h, p)) * 0.3)).astype(np.float32)
    return r, k, v, logw


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("with_state", [False, True])
def test_wkv_ref_matches_reference(with_state):
    r, k, v, logw = _wkv_inputs(0, 2, 40, 2, 32, 1.0)
    s0 = np.random.default_rng(1).standard_normal((2, 2, 32, 32)).astype(np.float32)
    s0 = s0 if with_state else None
    want_y, want_s = j_wkv_ref(*map(jnp.asarray, (r, k, v, logw)),
                               None if s0 is None else jnp.asarray(s0))
    got_y, got_s = wkv_ref(*map(torch.from_numpy, (r, k, v, logw)),
                           None if s0 is None else torch.from_numpy(s0))
    assert got_y.dtype == got_s.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), _np(want_y), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_s.numpy(), _np(want_s), rtol=1e-5, atol=1e-6)


# (head size, chunk, operands): fp32, bf16 r/k/v with fp32 logw (the
# model's case), or fp32 inputs through bf16 chunk operands
CHUNK_CASES = [(16, 8, "fp32"), (64, 16, "fp32"), (64, 8, "bf16"), (16, 16, "bf16"),
               (64, 16, "chunk_bf16")]


@pytest.mark.parametrize("decay", [1.0, 3.0])
@pytest.mark.parametrize("p,chunk,operands", CHUNK_CASES)
def test_chunked_wkv_matches_reference_and_pallas(p, chunk, operands, decay):
    r, k, v, logw = _wkv_inputs(int(decay) * 100 + p + chunk, 1, 64, 2, p, decay)
    cum = logw.reshape(1, 64 // chunk, chunk, 2, p).sum(axis=2)
    if decay == 3.0 and chunk == 16:
        assert (cum < -25).any()   # the clamp bites
    jx = [jnp.asarray(t) for t in (r, k, v, logw)]
    tx = [torch.from_numpy(t) for t in (r, k, v, logw)]
    if operands == "bf16":
        jx[:3] = [t.astype(jnp.bfloat16) for t in jx[:3]]
        tx[:3] = [t.to(torch.bfloat16) for t in tx[:3]]
    bf16_ops = operands == "chunk_bf16"
    jcfg = jr.RWKVConfig(d_model=2 * p, d_ff=2 * p, head_dim=p, chunk=chunk, chunk_bf16=bf16_ops)
    tcfg = tr.RWKVConfig(d_model=2 * p, d_ff=2 * p, head_dim=p, chunk=chunk, chunk_bf16=bf16_ops)
    want = jr._chunked_wkv(jcfg, *jx, jnp.zeros((1, 2, p, p), jnp.float32))
    got = tr._chunked_wkv(tcfg, *tx, torch.zeros((1, 2, p, p)))
    for g, w in zip(got, want):
        g, w = g.numpy(), _np(w)
        if bf16_ops:
            assert np.abs(g - w).max() <= 2.0 ** -7 * np.abs(w).max()
        else:
            np.testing.assert_allclose(g, w, **TIGHT)
    if not bf16_ops:
        kernel = j_wkv_kernel(*jx, chunk=chunk, interpret=True)
        for g, w in zip(got, kernel):
            np.testing.assert_allclose(g.numpy(), _np(w), **TIGHT)


@pytest.fixture(scope="module")
def block():
    """(reference config, params; port params) of one RWKV block, d 128 =
    2 heads of 64, d_ff 256."""
    cfg = jr.RWKVConfig(d_model=128, d_ff=256)
    jp = jr.init_rwkv(cfg, JInitializer("params", jax.random.key(0)))
    return cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(scale, s=64):
    return np.random.default_rng(1).standard_normal((2, s, 128)).astype(np.float32) * scale


def _port_cfg(jcfg):
    return tr.RWKVConfig(**dataclasses.asdict(jcfg))


def _clamped_share(cfg, jp, x, chunk=16):
    """Share of (chunk, channel) pairs whose log-decay sum passes -25."""
    *_, logw = jr._timemix_inputs(cfg, jp, jnp.asarray(x), jr._shift(jnp.asarray(x)))
    b, s, d = logw.shape
    return float((np.asarray(logw).reshape(b, s // chunk, chunk, d).sum(2) < -25).mean())


@pytest.mark.parametrize("branch", ["scan", "chunked", "kernel"])
def test_timemix_forward_matches_reference(branch, block):
    cfg, jp, tp = block
    if branch == "kernel":
        cfg = dataclasses.replace(cfg, chunk=16, use_pallas=True)
        x = _x(0.5)                                  # inside the clamp envelope
        assert _clamped_share(cfg, jp, x) == 0.0
    else:
        cfg = dataclasses.replace(cfg, chunk=16 if branch == "chunked" else 0)
        x = _x(1.0)                                  # the clamp bites in the chunked form
        assert _clamped_share(cfg, jp, x) > 0.0
    with japi.dispatch_mode("interpret"):
        want, want_cache = jr.timemix_forward(cfg, jp, jnp.asarray(x), return_cache=True)
    api.reset_counters()
    got, got_cache = tr.timemix_forward(_port_cfg(cfg), tp, torch.from_numpy(x),
                                        return_cache=True)
    assert api.call_counts() == ({"wkv_chunk": 1} if branch == "kernel" else {})
    tol = KERNEL_BRANCH if branch == "kernel" else dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), _np(want), **tol)
    for key in ("wkv", "shift_t"):
        np.testing.assert_allclose(got_cache[key].numpy(), _np(want_cache[key]), **tol)


def test_chanmix_forward_matches_reference(block):
    cfg, jp, tp = block
    x = _x(1.0)
    want, want_cache = jr.chanmix_forward(cfg, jp, jnp.asarray(x), return_cache=True)
    got, got_cache = tr.chanmix_forward(_port_cfg(cfg), tp, torch.from_numpy(x),
                                        return_cache=True)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got_cache["shift_c"].numpy(), x[:, -1:])


def test_decode_steps_reproduce_forward(block):
    """16 single steps of the time-mix and channel-mix decode give the
    forward pass's outputs and its cache, and the reference's steps."""
    cfg, jp, tp = block
    tcfg = _port_cfg(cfg)
    x = _x(1.0, s=16)
    xt = torch.from_numpy(x)
    tm_full, tm_cache = tr.timemix_forward(tcfg, tp, xt, return_cache=True)
    cm_full, cm_cache = tr.chanmix_forward(tcfg, tp, xt, return_cache=True)
    cache = tr.init_rwkv_cache(tcfg, 2, dtype=torch.float32)
    jcache = jr.init_rwkv_cache(cfg, 2, dtype=jnp.float32)
    for t in range(16):
        y, tc = tr.timemix_decode(tcfg, tp, xt[:, t:t + 1], cache)
        z, cc = tr.chanmix_decode(tcfg, tp, xt[:, t:t + 1], cache)
        jy, jtc = jr.timemix_decode(cfg, jp, jnp.asarray(x[:, t:t + 1]), jcache)
        _, jcc = jr.chanmix_decode(cfg, jp, jnp.asarray(x[:, t:t + 1]), jcache)
        cache, jcache = {**tc, **cc}, {**jtc, **jcc}
        np.testing.assert_allclose(y.numpy(), tm_full[:, t:t + 1].numpy(), **TIGHT)
        np.testing.assert_allclose(z.numpy(), cm_full[:, t:t + 1].numpy(), **TIGHT)
        np.testing.assert_allclose(y.numpy(), _np(jy), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(cache["wkv"].numpy(), tm_cache["wkv"].numpy(), **TIGHT)
    np.testing.assert_allclose(cache["wkv"].numpy(), _np(jcache["wkv"]), **TIGHT)
    for key, want in (("shift_t", tm_cache["shift_t"]), ("shift_c", cm_cache["shift_c"])):
        assert torch.equal(cache[key], want)
