"""The port's mixture-of-experts and Mamba-2 blocks against the reference's,
on the CPU.

Parameters come from the reference's initializer (``jax.random.key``) and
go through numpy to the port; inputs are numpy draws from a seed, given to
both sides, in fp32.

  * ``moe_forward`` in the three dispatch layouts ('auto',
    'gather_tokens', 'grouped' with 4 groups, and 'grouped' with a group
    count that does not divide the tokens, which falls back to one group),
    at capacity factors 8 (no drops), 1.0 and 0.5 (tokens dropped), with
    shared experts and with Arctic's dense residual: the output within
    rtol 1e-5 and an atol of 1e-6 of its largest magnitude, the router
    losses within rtol 1e-5, and the experts each token
    chose and the kept mask equal to the reference's.  The reference's
    experts are read off the one-hot its dispatch returns, and its kept
    mask is the exclusive prefix count over that one-hot in token-major
    order against the capacity, so a near tie shows as a routing mismatch
    and not as a loose tolerance.  'gather_tokens' is 'auto' bit for bit.
    The atol scales with the output because the reference's initializer
    takes an expert matrix's leading (expert) axis as its fan-in: at 4
    experts the outputs reach about 86, where an fp32 ulp is 7.6e-6, and
    where two gated expert outputs nearly cancel the two packages' GEMM
    summation orders leave a few such ulps (3.8e-5 at most here);
  * the reference's MoE invariants (``tests/test_model_units.py``) on the
    port: drops lower the output, the aux loss is finite and >= 0, grouped
    equals global where nothing drops, and shared experts answer a zeroed
    router (whose ties rank by expert index, as ``lax.top_k`` ranks them);
  * the reduced Qwen2-MoE model at a capacity factor of 1.0, where its
    first layer drops tokens: ``forward`` logits and ``loss`` (with the
    router losses) against the reference's;
  * ``mamba_forward`` (with its cache) and ``mamba_decode`` against the
    reference's, rtol 1e-5 / atol 1e-5, and the reference's two Mamba
    invariants on the port: the chunked scan equals the decode recurrence
    step by step, and its final state the decode state.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_reduced
from repro.models import Model as JModel
from repro.models import mamba as jmamba
from repro.models import mlp as jmlp
from repro.models.common import Initializer as JInitializer
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.models import Model
from repro_torch.models import mamba as tmamba
from repro_torch.models import mlp as tmlp

TOL = dict(rtol=1e-5, atol=1e-6)   # atol: relative to the largest |y| in _close
MAMBA_TOL = dict(rtol=1e-5, atol=1e-5)
D, F, E, K = 32, 48, 4, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's many small ops: beside other
    test workers, a pool of one OpenMP thread per core oversubscribes the
    CPU and spins, which slows these runs by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _moe(capacity_factor=8.0, seed=0, **kw):
    """(reference config, port config, reference params, port params)."""
    jcfg = jmlp.MoEConfig(d_model=D, d_ff=F, n_experts=E, top_k=K,
                          capacity_factor=capacity_factor, **kw)
    jp = jmlp.init_moe(jcfg, JInitializer("params", jax.random.key(seed)))
    tcfg = tmlp.MoEConfig(**dataclasses.asdict(jcfg))
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=TOL["rtol"],
                               atol=TOL["atol"] * float(np.abs(want).max()))


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _reference_routing(jcfg, jp, x):
    """The reference's experts and kept mask, (n_tok, k) in token order,
    under its layout's groups and capacity."""
    n_tok = x.shape[0] * x.shape[1]
    groups = jcfg.dispatch_groups if jcfg.dispatch_layout == "grouped" else 1
    groups = groups if n_tok % groups == 0 else 1
    per = n_tok // groups
    capacity = min(int(max(jcfg.top_k, jcfg.capacity_factor * per * jcfg.top_k
                           / jcfg.n_experts)), per)
    experts, keep = [], []
    for g in np.asarray(x).reshape(groups, per, -1):
        _, _, onehot, _ = jmlp._dispatch_compute_combine(jcfg, jp, jnp.asarray(g), capacity,
                                                         constrain=False)
        onehot = np.asarray(onehot)                              # (T, k, E)
        flat = onehot.reshape(per * jcfg.top_k, jcfg.n_experts)
        pos = ((np.cumsum(flat, axis=0) - flat) * flat).sum(-1).reshape(per, jcfg.top_k)
        experts.append(onehot.argmax(-1))
        keep.append(pos < capacity)
    return np.concatenate(experts), np.concatenate(keep)


LAYOUTS = [dict(dispatch_layout="auto"), dict(dispatch_layout="gather_tokens"),
           dict(dispatch_layout="grouped", dispatch_groups=4),
           dict(dispatch_layout="grouped", dispatch_groups=5)]   # 128 % 5: one group


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l['dispatch_layout']}"
                         f"{l.get('dispatch_groups', '')}")
@pytest.mark.parametrize("capacity_factor", [8.0, 1.0, 0.5])
def test_moe_forward_matches_reference(layout, capacity_factor):
    jcfg, tcfg, jp, tp = _moe(capacity_factor, **layout)
    x = _x((2, 64, D))
    jy, jaux = jmlp.moe_forward(jcfg, jp, jnp.asarray(x), return_aux=True)
    ty, taux = tmlp.moe_forward(tcfg, tp, torch.from_numpy(x), return_aux=True)
    experts, keep = tmlp.moe_routing(tcfg, tp, torch.from_numpy(x))
    want_experts, want_keep = _reference_routing(jcfg, jp, x)
    np.testing.assert_array_equal(experts.numpy(), want_experts)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert bool(keep.all()) == (capacity_factor == 8.0)   # 1.0 and 0.5 drop tokens
    _close(ty.numpy(), jy)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    y_only, none = tmlp.moe_forward(tcfg, tp, torch.from_numpy(x))
    assert none is None and torch.equal(y_only, ty)


@pytest.mark.parametrize("extra", [dict(n_shared_experts=2), dict(dense_residual=True),
                                   dict(dense_residual=True, dense_d_ff=40)],
                         ids=["shared", "dense", "dense_d_ff"])
@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
def test_moe_extra_branches_match_reference(extra, capacity_factor):
    jcfg, tcfg, jp, tp = _moe(capacity_factor, seed=2, **extra)
    x = _x((2, 32, D), seed=3)
    jy, jaux = jmlp.moe_forward(jcfg, jp, jnp.asarray(x), return_aux=True)
    ty, taux = tmlp.moe_forward(tcfg, tp, torch.from_numpy(x), return_aux=True)
    _close(ty.numpy(), jy)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert sorted(tp) == sorted(jp)


def test_moe_gather_tokens_is_auto_bit_for_bit():
    _, tcfg, _, tp = _moe(1.0)
    x = torch.from_numpy(_x((2, 64, D), seed=4))
    a, a_aux = tmlp.moe_forward(tcfg, tp, x, return_aux=True)
    b, b_aux = tmlp.moe_forward(dataclasses.replace(tcfg, dispatch_layout="gather_tokens"),
                                tp, x, return_aux=True)
    assert torch.equal(a, b) and torch.equal(a_aux, b_aux)


# ------------------------------------------------ the reference's invariants
def test_moe_capacity_drops_tokens():
    _, hi, _, tp = _moe(8.0)
    lo = dataclasses.replace(hi, capacity_factor=0.05)
    x = torch.from_numpy(_x((2, 64, D)))
    y_hi, _ = tmlp.moe_forward(hi, tp, x)
    y_lo, _ = tmlp.moe_forward(lo, tp, x)
    assert float(y_lo.abs().mean()) < float(y_hi.abs().mean())


def test_moe_aux_losses_finite_and_ordered():
    _, tcfg, _, tp = _moe(8.0)
    _, aux = tmlp.moe_forward(tcfg, tp, torch.from_numpy(_x((2, 32, D), seed=2)),
                              return_aux=True)
    assert np.isfinite(float(aux)) and float(aux) >= 0


def test_moe_grouped_matches_global():
    _, tcfg, _, tp = _moe(16.0)
    grouped = dataclasses.replace(tcfg, dispatch_layout="grouped", dispatch_groups=4)
    x = torch.from_numpy(_x((2, 32, D), seed=3))
    a, _ = tmlp.moe_forward(tcfg, tp, x)
    b, _ = tmlp.moe_forward(grouped, tp, x)
    _close(a.numpy(), b.numpy())


def test_moe_shared_expert_always_active():
    """With a zeroed router every probability ties: both sides rank the
    experts by index, and the shared expert still answers."""
    jcfg, tcfg, jp, tp = _moe(8.0, n_shared_experts=1)
    jp = {**jp, "router": jnp.zeros_like(jp["router"])}
    tp = {**tp, "router": torch.zeros_like(tp["router"])}
    x = _x((1, 16, D), seed=4)
    ty, _ = tmlp.moe_forward(tcfg, tp, torch.from_numpy(x))
    assert float(ty.abs().mean()) > 0
    experts, _ = tmlp.moe_routing(tcfg, tp, torch.from_numpy(x))
    assert (experts == torch.arange(K)).all()
    jy, _ = jmlp.moe_forward(jcfg, jp, jnp.asarray(x))
    _close(ty.numpy(), jy)


def test_moe_model_drops_tokens_like_the_reference():
    """Reduced Qwen2-MoE at a capacity factor of 1.0: the two-layer model
    drops tokens, and its logits and loss (with the router losses) match
    the reference's."""
    jcfg = dataclasses.replace(j_reduced("qwen2-moe-a2.7b"), capacity_factor=1.0)
    tcfg = dataclasses.replace(get_reduced("qwen2-moe-a2.7b"), capacity_factor=1.0)
    jm, tm = JModel(jcfg), Model(tcfg)
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 64)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    x, _ = tm._embed_inputs(tp, {"tokens": torch.from_numpy(tokens)}, torch.float32)
    layer0 = {k: v[0] for k, v in tp["blocks"]["b0"]["ffn"].items() if k != "shared"}
    _, keep = tmlp.moe_routing(tcfg.moe_cfg(), layer0, x)
    assert not bool(keep.all())
    jl, jaux = jm.forward(jp, {"tokens": jnp.asarray(tokens)}, dtype=jnp.float32)
    tl, taux = tm.forward(tp, {"tokens": torch.from_numpy(tokens)}, dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    batch = {"tokens": tokens, "targets": targets}
    jloss = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()}, dtype=jnp.float32)
    tloss = tm.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                    dtype=torch.float32)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


# ---------------------------------------------------------------- mamba
def _mamba(seed, **kw):
    jcfg = jmamba.MambaConfig(**kw)
    jp = jmamba.init_mamba(jcfg, JInitializer("params", jax.random.key(seed)))
    jp = {**jp, "a_log": jnp.asarray(_x(jp["a_log"].shape, seed + 10) * 0.5),
          "dt_bias": jnp.asarray(_x(jp["dt_bias"].shape, seed + 11) * 0.5)}
    tcfg = tmamba.MambaConfig(**dataclasses.asdict(jcfg))
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("chunk,seq", [(8, 32), (16, 16), (64, 32)])
def test_mamba_forward_and_decode_match_reference(chunk, seq):
    jcfg, tcfg, jp, tp = _mamba(0, d_model=32, d_inner=64, state_dim=8, head_dim=16,
                                chunk=chunk)
    x = _x((2, seq, 32), seed=1) * 0.5
    jy, jc = jmamba.mamba_forward(jcfg, jp, jnp.asarray(x), return_cache=True)
    ty, tc = tmamba.mamba_forward(tcfg, tp, torch.from_numpy(x), return_cache=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MAMBA_TOL)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **MAMBA_TOL)
    assert tc["ssm"].dtype == torch.float32
    # four decode steps on from the prefill's cache
    for t in range(4):
        u = _x((2, 1, 32), seed=20 + t) * 0.5
        jy, jc = jmamba.mamba_decode(jcfg, jp, jnp.asarray(u), jc)
        ty, tc = tmamba.mamba_decode(tcfg, tp, torch.from_numpy(u), tc)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MAMBA_TOL)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **MAMBA_TOL)


def test_mamba_chunked_equals_stepwise_decode():
    """The chunked SSD forward and the O(1) decode recurrence agree (the
    reference's tolerance, tests/test_model_units.py)."""
    _, tcfg, _, tp = _mamba(0, d_model=32, d_inner=64, state_dim=8, head_dim=16, chunk=8)
    x = torch.from_numpy(_x((2, 32, 32), seed=1) * 0.5)
    full = tmamba.mamba_forward(tcfg, tp, x)
    cache = tmamba.init_mamba_cache(tcfg, 2, dtype=torch.float32, device="cpu")
    outs = []
    for t in range(32):
        y, cache = tmamba.mamba_decode(tcfg, tp, x[:, t:t + 1], cache)
        outs.append(y)
    np.testing.assert_allclose(full.numpy(), torch.cat(outs, dim=1).numpy(),
                               rtol=2e-3, atol=2e-3)


def test_mamba_final_state_matches_decode_state():
    _, tcfg, _, tp = _mamba(2, d_model=16, d_inner=32, state_dim=4, head_dim=8, chunk=4)
    x = torch.from_numpy(_x((1, 16, 16), seed=3) * 0.5)
    _, cache_full = tmamba.mamba_forward(tcfg, tp, x, return_cache=True)
    cache = tmamba.init_mamba_cache(tcfg, 1, dtype=torch.float32, device="cpu")
    for t in range(16):
        _, cache = tmamba.mamba_decode(tcfg, tp, x[:, t:t + 1], cache)
    np.testing.assert_allclose(cache_full["ssm"].numpy(), cache["ssm"].numpy(),
                               rtol=2e-3, atol=2e-4)
    with pytest.raises(ValueError, match="chunks of"):
        tmamba.mamba_forward(tcfg, tp, x[:, :6])
