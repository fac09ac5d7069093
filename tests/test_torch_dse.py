"""DSE-MVR / DSE-SGD of the port (``repro_torch.core.dse``) against the
reference (``repro.core.dse``): one ``local_update`` and one ``comm_update``
from the same numpy state, for both algorithms, both tracking-buffer
layouts and both ``use_fused`` paths (on the CPU the fused path runs the
plain versions of the kernels through the bucketed backend).

Tolerance rtol 1e-5 / atol 1e-6 on every state leaf: one step of fp32
arithmetic that XLA and ATen associate differently (the dense mix is a
matmul on both sides) moves values by a few ulps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dse as jdse
from repro.core.mixing import dense_mix as jdense_mix
from repro.core.topology import ring
from repro.optim import schedules as jsched
from repro_torch.convert import state_from_numpy, tree_to_numpy
from repro_torch.core import dse as tdse
from repro_torch.core.mixing import dense_mix as tdense_mix
from repro_torch.optim import schedules as tsched

TOL = dict(rtol=1e-5, atol=1e-6)
N = 4
SHAPES = {"w": (N, 5, 3), "b": (N, 3)}
STEP = 13   # past the first lr decay of a 20-step schedule


def _np_tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def _np_state(fuse, seed=0):
    rng = np.random.default_rng(seed)
    params = _np_tree(rng)
    st = dict(params=params, x_ref=_np_tree(rng), v=_np_tree(rng, 0.5),
              y=None, h_prev=None, z=None, step=np.int32(STEP))
    if fuse:
        st["z"] = _np_tree(rng, 0.1)
    else:
        st["y"], st["h_prev"] = _np_tree(rng, 0.1), _np_tree(rng, 0.1)
    return st


def _grad_consts(seed=1):
    rng = np.random.default_rng(seed)
    return _np_tree(rng), _np_tree(rng)


def _jax_grads():
    c, d = _grad_consts()
    c, d = jax.tree.map(jnp.asarray, c), jax.tree.map(jnp.asarray, d)
    mini = lambda p: jax.tree.map(lambda x, ci, di: jnp.tanh(x) * ci + di, p, c, d)  # noqa: E731
    full = lambda p: jax.tree.map(lambda x, ci: jnp.sin(x) * ci, p, c)  # noqa: E731
    return mini, full


def _torch_grads():
    c, d = _grad_consts()
    c = {k: torch.from_numpy(v) for k, v in c.items()}
    d = {k: torch.from_numpy(v) for k, v in d.items()}
    mini = lambda p: {k: torch.tanh(p[k]) * c[k] + d[k] for k in p}  # noqa: E731
    full = lambda p: {k: torch.sin(p[k]) * c[k] for k in p}  # noqa: E731
    return mini, full


def _algs(name, fuse, use_fused):
    kw = dict(tau=4, fuse_tracking_buffers=fuse, use_fused=use_fused)
    if name == "dse_mvr":
        j = jdse.DSEMVR(lr=jsched.paper_mnist_schedule(0.3, 20),
                        alpha=jsched.decay_weight(0.05, 0.99), **kw)
        t = tdse.DSEMVR(lr=tsched.paper_mnist_schedule(0.3, 20),
                        alpha=tsched.decay_weight(0.05, 0.99), **kw)
    else:
        j = jdse.DSESGD(lr=jsched.paper_mnist_schedule(0.3, 20), **kw)
        t = tdse.DSESGD(lr=tsched.paper_mnist_schedule(0.3, 20), **kw)
    return j, t


@pytest.mark.parametrize("phase", ["local", "comm"])
@pytest.mark.parametrize("use_fused", [False, True])
@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("name", ["dse_mvr", "dse_sgd"])
def test_one_step_matches_reference(name, fuse, use_fused, phase):
    np_state = _np_state(fuse)
    jalg, talg = _algs(name, fuse, use_fused)
    jstate = jdse.DSEState(**{k: (None if v is None else jax.tree.map(jnp.asarray, v))
                              for k, v in np_state.items()})
    tstate = state_from_numpy(np_state, "cpu")
    jmini, jfull = _jax_grads()
    tmini, tfull = _torch_grads()
    w = ring(N).w
    if phase == "local":
        jout = jalg.local_update(jstate, jmini)
        tout = talg.local_update(tstate, tmini)
    else:
        # as the round executor hands them: DSE-MVR resets v with the full
        # gradient, DSE-SGD with the round's minibatch gradient
        jreset = jfull if name == "dse_mvr" else jmini
        treset = tfull if name == "dse_mvr" else tmini
        jout = jalg.comm_update(jstate, jdense_mix(w), jmini, jreset)
        tout = talg.comm_update(tstate, tdense_mix(w), tmini, treset)
    assert tout.step == int(jout.step) == STEP + 1
    for field in ("params", "x_ref", "v", "y", "h_prev", "z"):
        jt, tt = getattr(jout, field), getattr(tout, field)
        assert (jt is None) == (tt is None), field
        if jt is None:
            continue
        got = tree_to_numpy(tt)
        for k in SHAPES:
            assert got[k].dtype == np.float32
            np.testing.assert_allclose(got[k], np.asarray(jt[k]), **TOL, err_msg=f"{field}.{k}")


@pytest.mark.parametrize("t", [0, 1, 9, 10, 14, 15, 19, 57, 199])
def test_schedules_match_reference_in_float32(t):
    """gamma and alpha on the host equal the reference's fp32 values (alpha's
    power may differ by an ulp between libm and XLA)."""
    assert tsched.paper_mnist_schedule(0.3, 20)(t) == float(jsched.paper_mnist_schedule(0.3, 20)(t))
    assert tsched.constant(0.1)(t) == float(jsched.constant(0.1)(t))
    np.testing.assert_allclose(tsched.decay_weight(0.05, 0.99)(t),
                               float(jsched.decay_weight(0.05, 0.99)(t)), rtol=2e-7)


def test_init_matches_reference():
    """v0 = full local gradient, zero tracking buffers, x_ref = params."""
    np_params = _np_state(False)["params"]
    _, jfull = _jax_grads()
    _, tfull = _torch_grads()
    for fuse in (False, True):
        jalg, talg = _algs("dse_mvr", fuse, False)
        jst = jalg.init(jax.tree.map(jnp.asarray, np_params), jfull)
        tst = talg.init({k: torch.from_numpy(v) for k, v in np_params.items()}, tfull)
        assert tst.step == 0
        for field in ("params", "x_ref", "v", "y", "h_prev", "z"):
            jt, tt = getattr(jst, field), getattr(tst, field)
            assert (jt is None) == (tt is None)
            if jt is not None:
                for k in SHAPES:
                    np.testing.assert_allclose(tree_to_numpy(tt)[k], np.asarray(jt[k]), **TOL)


def test_compression_and_channels_not_ported():
    """Every codec and channel of the dense engine builds, with the
    reference's tags; only the sharded engine's wire modes raise, and they
    name the ROADMAP item."""
    from repro.core import dse as jdse

    for kw in (dict(compression="qsgd"), dict(compression="top_k"),
               dict(compression="top_k:0.1", channel="choco"),
               dict(compression="rand_k:0.25", channel="async:2"),
               dict(compression="low_rank:2", channel={"params": "choco"}),
               dict(compression="top_k:0.1", channel="choco", overlap=True),
               dict(channel={"params": "sync"})):
        t = tdse.DSEMVR(lr=0.1, **kw).comm.resolved_channel()
        j = jdse.DSEMVR(lr=0.1, **kw).comm.resolved_channel()
        assert (t is None and j is None) or t.tag == j.tag, kw
    from repro_torch.compression import ChocoChannel

    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        tdse.DSEMVR(lr=0.1, compression="top_k:0.1", channel=ChocoChannel(neighbor_shifts=(1,)))
    assert tdse.DSEMVR(lr=0.1, compression="qsgd").comm.resolved_channel().tag == "sync_ef_qsgd"
    assert dataclasses.is_dataclass(tdse.DSEState)
