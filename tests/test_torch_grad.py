"""Gradients through the port's fused ops and models against the
reference's, on the CPU.

The reference's ops are ``jax.custom_vjp``s whose backward is the vjp of
the op's plain version; the port's are ``torch.autograd.Function``s whose
backward recomputes the plain version and differentiates it.  From the
same numpy inputs and cotangents:

  * each shaped op through ``api.call`` (flash attention with GQA, a window
    and a softcap, causal and not; rms_norm; the wkv recurrence; the top-k
    pack and unpack, whose integer indices get no gradient) against
    ``jax.vjp`` of the reference's ``api.call``, within rtol 1e-5 / atol
    1e-6 (fp32 both sides, other summation orders);
  * each elementwise op through ``api.tree_apply`` on a tree of fp32 and
    bf16 leaves against ``jax.vjp`` of the reference's: fp32 leaves within
    rtol 1e-6 / atol 1e-7, bf16 leaves within one bf16 ulp (each side
    rounds the same fp32 value once); the QSGD payload (int8) gets none;
  * ``torch.autograd.grad`` of ``Model.loss`` (fp32) against ``jax.grad``
    of the reference's, from the same converted parameters, for Gemma-2
    (flash op), RWKV-6 (the wkv op), Qwen1.5-MoE, Zamba2, Qwen2-VL (flash
    op, text-position loss) and HuBERT: each leaf within 1e-4 of that
    leaf's largest |gradient| (a probe of these six losses found at most
    1.1e-5; the reference's ops run their plain version, as the port's do
    on CPU tensors);
  * with grad off, or no input that requires it, the dispatch is the one
    it was: the same values bit for bit, the same counts, no graph; the
    backward adds no call and no launch.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401  (populates the reference registry)
from repro.configs import get_reduced as j_reduced
from repro.kernels import api as japi
from repro.models import Model as JModel
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import api as tapi
from repro_torch.models import Model
from repro_torch.tree import tree_flatten

SHAPED_TOL = dict(rtol=1e-5, atol=1e-6)
TOL32 = dict(rtol=1e-6, atol=1e-7)
LOSS_GRAD_BAND = 1e-4
B, S = 2, 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small ops: beside other test
    workers, a pool of one OpenMP thread per core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vjp_pair(name, arrays, cts, float_mask, **static):
    """(port gradients, reference gradients) of ``call(name, *arrays)``
    with cotangents ``cts``; ``None`` for the inputs ``float_mask`` leaves
    out."""
    with japi.dispatch_mode("ref"):
        out, vjp = jax.vjp(lambda *xs: japi.call(name, *xs, **static),
                           *[jnp.asarray(a) for a in arrays])
        jg = vjp(tuple(jnp.asarray(c) for c in cts) if isinstance(out, tuple)
                 else jnp.asarray(cts[0]))
    ts = [torch.from_numpy(a).requires_grad_(m) for a, m in zip(arrays, float_mask)]
    tapi.reset_counters()
    got = tapi.call(name, *ts, **static)
    got = got if isinstance(got, tuple) else (got,)
    assert all(o.requires_grad for o in got if o.is_floating_point())
    wrt = [t for t in ts if t.requires_grad]
    tg = torch.autograd.grad(got, wrt, [torch.from_numpy(c) for c in cts])
    # one plain dispatch, and the backward adds nothing
    assert tapi.call_counts() == {name: 1} and tapi.launch_counts() == {}
    tg = iter(tg)
    return [next(tg) if m else None for m in float_mask], jg


def _rng_f32(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("h,kh,d,window,softcap,causal", [
    (4, 2, 32, None, None, True), (4, 1, 32, 16, 50.0, True), (2, 2, 64, None, 30.0, False),
])
def test_flash_attention_gradient_matches_reference(h, kh, d, window, softcap, causal):
    rng = np.random.default_rng(0)
    q, k, v = (_rng_f32(rng, (2, 64, n, d)) for n in (h, kh, kh))
    ct = _rng_f32(rng, (2, 64, h, d))
    tg, jg = _vjp_pair("flash_attention", (q, k, v), (ct,), (True, True, True),
                       causal=causal, sliding_window=window, softcap=softcap)
    for g, w in zip(tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **SHAPED_TOL)


@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm_gradient_matches_reference(plus_one):
    rng = np.random.default_rng(1)
    x, w, ct = _rng_f32(rng, (3, 5, 96)), _rng_f32(rng, (96,)), _rng_f32(rng, (3, 5, 96))
    tg, jg = _vjp_pair("rms_norm", (x, w), (ct,), (True, True), eps=1e-6, plus_one=plus_one)
    for g, want in zip(tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **SHAPED_TOL)


def test_wkv_chunk_gradient_matches_reference():
    """Both sides differentiate the exact per-token recurrence (the op's
    plain version), both outputs (y and the final state) carrying
    cotangents."""
    rng = np.random.default_rng(2)
    b, s, h, p = 1, 32, 2, 16
    r, k, v = (_rng_f32(rng, (b, s, h, p)) * 0.5 for _ in range(3))
    logw = -np.exp(_rng_f32(rng, (b, s, h, p)) * 0.5 - 1.0)
    cts = (_rng_f32(rng, (b, s, h, p)), _rng_f32(rng, (b, h, p, p)))
    tg, jg = _vjp_pair("wkv_chunk", (r, k, v, logw), cts, (True,) * 4, chunk=16)
    for g, w in zip(tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_top_k_gradients_match_reference():
    """The pack's gradient scatters into x, the unpack's gathers into the
    values; the integer indices get none, in both packages (float0)."""
    rng = np.random.default_rng(3)
    n, d, kk = 3, 40, 7
    x = _rng_f32(rng, (n, d))
    idx = np.stack([rng.permutation(d)[:kk] for _ in range(n)]).astype(np.int32)
    tg, jg = _vjp_pair("top_k_pack", (x, idx), (_rng_f32(rng, (n, kk)),), (True, False))
    np.testing.assert_allclose(tg[0].numpy(), np.asarray(jg[0]), **SHAPED_TOL)
    assert tg[1] is None and jg[1].dtype == jax.dtypes.float0
    vals = _rng_f32(rng, (n, kk))
    tg, jg = _vjp_pair("top_k_unpack", (idx, vals), (_rng_f32(rng, (n, d)),), (False, True),
                       d=d)
    assert tg[0] is None and jg[0].dtype == jax.dtypes.float0
    np.testing.assert_allclose(tg[1].numpy(), np.asarray(jg[1]), **SHAPED_TOL)


# op -> (scalars, one input maker per input); the QSGD payload is int8
ELEMENTWISE = {
    "mvr_update": ((0.05,), ("normal",) * 3),
    "axpby": ((-0.3, 1.0), ("normal",) * 2),
    "add_sub": ((), ("normal",) * 3),
    "dse_combine": ((0.3,), ("normal",) * 4),
    "dse_combine_yh": ((0.3,), ("normal",) * 5),
    "qsgd_quantize": ((127.0,), ("unit", "uniform")),
    "qsgd_dequantize": ((1.0 / 127,), ("levels", "positive")),
}
LEAVES = {"a": ((3, 7), "float32"), "b": ((101,), "bfloat16"), "c": ((5,), "float32")}


def _leaf(rng, kind, shape):
    if kind == "levels":
        return rng.integers(-127, 128, shape).astype(np.int8)
    x = {"normal": lambda: rng.standard_normal(shape),
         "unit": lambda: rng.uniform(-1, 1, shape),
         "uniform": lambda: rng.uniform(0, 1, shape),
         "positive": lambda: rng.uniform(0.1, 2.0, shape)}[kind]()
    return x.astype(np.float32)


def _bf16_round(x):
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("name", sorted(ELEMENTWISE))
def test_elementwise_gradient_matches_reference(name):
    scalars, kinds = ELEMENTWISE[name]
    rng = np.random.default_rng(4)
    trees = [{k: _leaf(rng, kind, shape) for k, (shape, _) in LEAVES.items()} for kind in kinds]
    # bf16 leaves hold bf16 values on both sides
    trees = [{k: (_bf16_round(v) if LEAVES[k][1] == "bfloat16" and v.dtype != np.int8 else v)
              for k, v in t.items()} for t in trees]
    n_out = tapi.get(name).n_outputs
    cts = [{k: _bf16_round(_leaf(rng, "normal", shape)) for k, (shape, _) in LEAVES.items()}
           for _ in range(n_out)]

    def jdt(k, v):
        return jnp.int8 if v.dtype == np.int8 else jnp.dtype(LEAVES[k][1])

    jtrees = [{k: jnp.asarray(v).astype(jdt(k, v)) for k, v in t.items()} for t in trees]
    with japi.dispatch_mode("ref"):
        out, vjp = jax.vjp(lambda *ts: japi.call(name, *ts, scalars=scalars), *jtrees)
        jct = [{k: jnp.asarray(v).astype(out_leaf.dtype)
                for (k, v), out_leaf in zip(ct.items(), (o[k] for k in ct))}
               for ct, o in zip(cts, out if n_out > 1 else (out,))]
        jg = vjp(tuple(jct) if n_out > 1 else jct[0])

    def tdt(k, v):
        return torch.int8 if v.dtype == np.int8 else getattr(torch, LEAVES[k][1])

    ttrees = [{k: torch.from_numpy(v).to(tdt(k, v)).requires_grad_(v.dtype != np.int8)
               for k, v in t.items()} for t in trees]
    tapi.reset_counters()
    got = tapi.call(name, *ttrees, scalars=scalars)
    got = got if n_out > 1 else (got,)
    calls = tapi.call_counts()
    outs, grads_in, wrt = [], [], []
    for o, ct in zip(got, cts):
        for k in LEAVES:
            outs.append(o[k])
            grads_in.append(torch.from_numpy(ct[k]).to(o[k].dtype))
    for t in ttrees:
        wrt += [t[k] for k in LEAVES if t[k].requires_grad]
    tg = iter(torch.autograd.grad(outs, wrt, grads_in))
    assert tapi.call_counts() == calls == {name: 2} and tapi.launch_counts() == {}
    for t, jt in zip(ttrees, jg):
        for k, (_, dt) in LEAVES.items():
            if not t[k].requires_grad:
                assert jt[k].dtype == jax.dtypes.float0
                continue
            g, w = next(tg).float().numpy(), np.asarray(jt[k].astype(jnp.float32))
            if dt == "bfloat16":
                ulp = np.ldexp(np.float32(1), np.frexp(np.maximum(np.abs(g), np.abs(w)))[1] - 8)
                assert np.all(np.abs(g - w) <= ulp), (name, k)
            else:
                np.testing.assert_allclose(g, w, **TOL32)


def test_dispatch_without_grad_is_unchanged():
    """Forward values under grad are the plain dispatch's bit for bit, with
    the same counts; with grad off, or no input requiring it, no graph."""
    rng = np.random.default_rng(5)
    x, y = ({"a": torch.from_numpy(_rng_f32(rng, (4, 9))), "b": torch.from_numpy(
        _rng_f32(rng, (7,))).to(torch.bfloat16)} for _ in range(2))
    q = torch.from_numpy(_rng_f32(rng, (1, 32, 2, 16)))
    tapi.reset_counters()
    plain = tapi.tree_axpby(0.5, x, -1.5, y)
    plain_attn = tapi.call("flash_attention", q, q, q, causal=True)
    counts = tapi.call_counts()
    assert plain_attn.grad_fn is None and all(v.grad_fn is None for v in plain.values())
    tapi.reset_counters()
    xg = {k: v.clone().requires_grad_() for k, v in x.items()}
    qg = q.clone().requires_grad_()
    graded = tapi.tree_axpby(0.5, xg, -1.5, y)
    graded_attn = tapi.call("flash_attention", qg, q, q, causal=True)
    assert tapi.call_counts() == counts
    assert graded_attn.grad_fn is not None and torch.equal(graded_attn, plain_attn)
    for k in x:
        assert graded[k].grad_fn is not None and torch.equal(graded[k], plain[k])
    with torch.no_grad():
        off = tapi.call("flash_attention", qg, q, q, causal=True)
        off_tree = tapi.tree_axpby(0.5, xg, -1.5, y)
    assert off.grad_fn is None and torch.equal(off, plain_attn)
    assert all(v.grad_fn is None for v in off_tree.values())


LOSS_ARCHS = {
    "gemma2_2b": dict(attn_impl="pallas"),
    "rwkv6_3b": dict(rwkv_chunk=16, rwkv_pallas=True),
    "qwen2_moe_a2_7b": {},
    "zamba2_7b": {},
    "qwen2_vl_2b": dict(attn_impl="pallas"),
    "hubert_xlarge": {},
}


def _loss_batch(cfg):
    rng = np.random.default_rng(6)
    if cfg.audio_frontend_dim:
        return {"frames": _rng_f32(rng, (B, S, cfg.audio_frontend_dim)),
                "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    tokens = rng.integers(0, cfg.vocab_size, (B, S - cfg.n_vision_tokens)).astype(np.int32)
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}
    if cfg.n_vision_tokens:
        batch["vision_embeds"] = _rng_f32(rng, (B, cfg.n_vision_tokens, cfg.d_model))
    return batch


@pytest.mark.parametrize("arch", sorted(LOSS_ARCHS))
def test_loss_gradient_matches_reference(arch):
    kw = LOSS_ARCHS[arch]
    jm = JModel(dataclasses.replace(j_reduced(arch), **kw))
    jp = jm.init(jax.random.key(0))
    batch = _loss_batch(jm.cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with japi.dispatch_mode("ref"):
        jloss, jg = jax.value_and_grad(lambda p: jm.loss(p, jb, dtype=jnp.float32))(jp)
    tm = Model(dataclasses.replace(get_reduced(arch), **kw))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    leaves, _ = tree_flatten(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tapi.reset_counters()
    loss = tm.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, dtype=torch.float32)
    calls = tapi.call_counts()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert tapi.call_counts() == calls and tapi.launch_counts() == {}
    op = {"attn_impl": "flash_attention", "rwkv_pallas": "wkv_chunk"}
    want_calls = {op[k]: tm.cfg.n_layers for k in kw if k in op}
    assert calls == want_calls, calls
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    jleaves = jax.tree.leaves(jg)
    assert len(grads) == len(jleaves)
    for g, w in zip(grads, jleaves):
        w = np.asarray(w)
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=LOSS_GRAD_BAND * np.abs(w).max())
