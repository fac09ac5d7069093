"""The port's scenario engine (``repro_torch.scenarios``, the scheduled
executor, the scheduled dense mix, the channels' round knobs and the
Simulator's scenario branch) against the reference's (``repro.scenarios``).

Minibatch indices and codec seeds are replayed from the reference's keys as
in ``test_torch_simulator.py`` and ``test_torch_compression.py``: the
reference's scheduled scan splits its key once per iteration in the same
order as its static one, so ``_reference_indices`` serves scenario runs
unchanged.  The port applies the per-node batch-size tiling itself.

Tolerances:
  * ``Scenario.materialize``: every array identical (numpy on both sides,
    the same generator draws); ``to_config`` equal;
  * the metric functions on the same numpy state: rtol 1e-5 / atol 1e-6
    (fp32 reductions in other orders; ``eigvalsh`` of LAPACK against XLA's);
  * one or two scheduled rounds from the same state, masks and seeds, with a
    dense mix both sides compute in float64 numpy: rtol 1e-5 / atol 1e-6 on
    every buffer and on the wire (``STATE_TOL``); steps, ages, send masks
    and payload indices exactly;
  * ``Simulator.run`` against the reference's, history and streams:
    rtol 5e-4 / atol 1e-5 (the main-path band of ``test_torch_simulator``),
    ``test_acc`` within 2/1000, over 66 steps (16 rounds and two trailing
    local steps); the codec runs (``warmup_compress`` with ``top_k:0.1``,
    ``async_lossy`` with ``async:3``) over 64 steps in the compressed band,
    rtol 5e-3 / atol 1e-5 and 5/1000 on ``test_acc``
    (``test_torch_channels``); ``active_nodes`` exactly, NaN where the
    reference streams NaN;
  * the ``baseline`` scenario against the static ring, in the port: bit for
    bit, states, history and kernel dispatch counts.
"""
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common as jcommon
from repro.compression import AsyncChannel as JAsyncChannel
from repro.compression import ChannelState as JChannelState
from repro.compression import SyncChannel as JSyncChannel
from repro.compression import Transport as JTransport
from repro.compression import attach_channel_state as j_attach
from repro.compression import make_compressor as j_make_compressor
from repro.compression.base import _wire_entries as j_wire_entries
from repro.compression.base import compression_error as j_compression_error
from repro.core import DSEState as JDSEState
from repro.core import Simulator as JSimulator
from repro.core import make_algorithm as j_registry_make
from repro.core.algorithm import RoundCtx as JRoundCtx
from repro.core.algorithm import make_round_step as j_make_round_step
from repro.scenarios import SCENARIOS as J_SCENARIOS
from repro.scenarios import make_scenario as j_make_scenario
from repro.scenarios import metrics as jmetrics
from repro.scenarios import renormalize_dropout as j_renormalize_dropout
from repro_torch import paper_problem as tproblem
from repro_torch.compression import (
    AsyncChannel, ChannelState, Packed, SyncChannel, Transport,
    attach_channel_state, compression_error, make_compressor,
)
from repro_torch.compression.base import _wire_entries
from repro_torch.convert import params_from_numpy, state_from_numpy, tree_to_numpy
from repro_torch.core import ALGORITHMS, DSEState, RoundCtx, Simulator, ring, torus
from repro_torch.core import make_algorithm as t_registry_make
from repro_torch.core.algorithm import _select_nodes, make_round_step
from repro_torch.kernels import api as tapi
from repro_torch.scenarios import SCENARIOS, STREAM_FIELDS, make_scenario
from repro_torch.scenarios import metrics as tmetrics
from test_torch_channels import SHAPES, _assert_wire_close, _np_tree, _start_wire
from test_torch_compression import CHANNEL_TAG, ReferenceDraws, _reference_like
from test_torch_simulator import _reference_indices, _reference_init

STATE_TOL = dict(rtol=1e-5, atol=1e-6)
RUN_RTOL, RUN_ATOL, ACC_TOL = 5e-4, 1e-5, 2e-3
CODEC_RTOL, CODEC_ACC_TOL = 5e-3, 5e-3
N, B, TAU, OMEGA, SEED = 8, 16, 4, 0.5, 0
ACTIVE = np.array([1, 1, 0, 1, 1, 1, 0, 1], bool)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's many small ops: beside other
    test workers, a pool of one OpenMP thread per core oversubscribes the
    CPU and spins, which slows these runs by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ materialize
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("n", [8, 5])
@pytest.mark.parametrize("name", sorted(J_SCENARIOS))
def test_materialize_matches_reference(name, n, seed):
    """Every registered preset gives the reference's arrays from the same
    seed, and the same spec flags, config and host-side gaps."""
    assert sorted(SCENARIOS) == sorted(J_SCENARIOS)
    got, want = make_scenario(name, seed=seed), j_make_scenario(name, seed=seed)
    assert got.to_config() == want.to_config()
    for flag in ("mutates_w", "needs_local_gate", "needs_active_gate"):
        assert getattr(got, flag) == getattr(want, flag), flag
    assert got.is_degenerate() == want.is_degenerate()
    for rl in (TAU, 1):
        gs, ws = got.materialize(n, 12, rl, batch_size=B), want.materialize(n, 12, rl, batch_size=B)
        for f in dataclasses.fields(ws):
            a, b = getattr(gs, f.name), getattr(ws, f.name)
            assert (a is None) == (b is None), f.name
            if b is not None:
                assert a.dtype == b.dtype, f.name
                np.testing.assert_array_equal(a, b, err_msg=f.name)
        np.testing.assert_array_equal(gs.spectral_gaps(), ws.spectral_gaps())
    rots, jrots = got.topology_schedule(n).rotations(), want.topology_schedule(n).rotations()
    assert (rots is None) == (jrots is None)
    if rots is not None:
        assert [dataclasses.astuple(r) for r in rots] == [dataclasses.astuple(r) for r in jrots]


# ---------------------------------------------------------------- metrics
_METRIC_CHANNELS = {
    "sync_ef": dict(compression="top_k:0.1"),
    "choco": dict(compression="top_k:0.1", channel="choco"),
    "async": dict(channel=JAsyncChannel(max_staleness=4, threshold=0.1)),
}


def _metric_states(kind):
    """(reference state, port state) of DSE-MVR with the kind's wire state,
    from the same numpy fields."""
    rng = np.random.default_rng(5)
    fields = dict(params=_np_tree(rng), x_ref=_np_tree(rng), v=_np_tree(rng, 0.5),
                  y=_np_tree(rng, 0.1), h_prev=_np_tree(rng, 0.1))
    jalg = j_registry_make("dse_mvr", lr=0.1, tau=1, **_METRIC_CHANNELS[kind])
    wire = _start_wire(jalg, fields, rng, fresh=False)
    key = jax.random.key(0)
    jstate = JDSEState(**{k: jax.tree.map(jnp.asarray, v) for k, v in fields.items()}, z=None,
                       step=jnp.int32(3), comp=JChannelState(wire=jax.tree.map(jnp.asarray, wire),
                                                             key=key))
    tstate = state_from_numpy(_reference_like("DSEState", dict(fields, z=None), step=np.int32(3),
                                              comp=JChannelState(wire=wire, key=key)), "cpu")
    return jstate, tstate


def _w_dropout(active):
    return j_renormalize_dropout(ring(N).w, active).astype(np.float32)


def _lin_grad(xbar):
    """A gradient-at-mean stand-in both sides compute in the same steps."""
    return {k: (v * 0.5 + 0.25) for k, v in xbar.items()}


@pytest.mark.parametrize("active", [ACTIVE, None], ids=["dropout", "all"])
@pytest.mark.parametrize("kind", sorted(_METRIC_CHANNELS))
def test_metric_functions_match_reference(kind, active):
    jstate, tstate = _metric_states(kind)
    ja = None if active is None else jnp.asarray(active)
    ta = None if active is None else torch.from_numpy(active)
    w = _w_dropout(ACTIVE if active is None else active)
    bufs = ("y", "params")
    pairs = {
        "consensus": (jmetrics.masked_consensus(jstate.params, ja),
                      tmetrics.masked_consensus(tstate.params, ta)),
        "tracking_mean": (jmetrics.tracking_error(jstate, ja, None, "v"),
                          tmetrics.tracking_error(tstate, ta, None, "v")),
        "tracking_grad": (jmetrics.tracking_error(jstate, ja, _lin_grad, "v"),
                          tmetrics.tracking_error(tstate, ta, _lin_grad, "v")),
        "tracking_none": (jmetrics.tracking_error(jstate, ja, None, None),
                          tmetrics.tracking_error(tstate, ta, None, None)),
        "spectral_gap": (jmetrics.effective_spectral_gap(jnp.asarray(w), ja),
                         tmetrics.effective_spectral_gap(torch.from_numpy(w), ta)),
        "replica_drift": (jmetrics.replica_drift(jstate, bufs),
                          tmetrics.replica_drift(tstate, bufs)),
        "replica_drift_no_names": (jmetrics.replica_drift(jstate, None),
                                   tmetrics.replica_drift(tstate, None)),
        "staleness": (jmetrics.staleness(jstate), tmetrics.staleness(tstate)),
        "send_rate": (jmetrics.send_rate(jstate), tmetrics.send_rate(tstate)),
        "compression_err": (j_compression_error(jstate), compression_error(tstate)),
    }
    jctx = JRoundCtx(w=jnp.asarray(w), active=ja)
    tctx = RoundCtx(w=torch.from_numpy(w), active=ta)
    jys = jmetrics.make_stream_fn(_lin_grad, "v", bufs)(jstate, jctx)
    tys = tmetrics.make_stream_fn(_lin_grad, "v", bufs)(tstate, tctx)
    assert list(tys) == list(STREAM_FIELDS) and sorted(jys) == sorted(STREAM_FIELDS)
    pairs.update({f"stream.{k}": (jys[k], tys[k]) for k in STREAM_FIELDS})
    for what, (want, got) in pairs.items():
        assert got.dim() == 0 and got.dtype == torch.float32, what
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **STATE_TOL, err_msg=what)
    for k in ("res", "hat", "age", "sent", "fly"):
        assert len(_wire_entries(tstate, k)) == len(j_wire_entries(jstate, k)), k


def test_spectral_gap_batches_rounds():
    """One batched call over (R, N, N) gives each round's gap, the reference's
    per-round values, including a round with one active node."""
    sched = make_scenario("hostile").materialize(N, 6, TAU)
    sched.active[5] = False
    sched.active[5, 2] = True
    got = tmetrics.effective_spectral_gap(torch.from_numpy(sched.w), torch.from_numpy(sched.active))
    want = [float(jmetrics.effective_spectral_gap(jnp.asarray(w), jnp.asarray(a)))
            for w, a in zip(sched.w, sched.active)]
    assert got.shape == (6,)
    np.testing.assert_allclose(got.numpy(), want, **STATE_TOL)


def test_compression_error_nan_lies_on_the_state_device():
    """Without residuals the NaN is a 0-d fp32 tensor on the params' device
    (here the meta device, standing in for a card)."""
    meta = {"w": torch.empty(N, 3, device="meta")}
    for comp in (None, ChannelState(wire=({"hat": meta}, None))):
        st = type("S", (), dict(params=meta, comp=comp))()
        for fn in (compression_error, tmetrics.replica_drift, tmetrics.staleness,
                   tmetrics.send_rate):
            out = fn(st)
            assert out.device.type == "meta" and out.dim() == 0 and out.dtype == torch.float32
    assert _wire_entries(type("S", (), dict(comp=None))(), "res") == []


# --------------------------------------------------------- one round each
def _np_mix_w(tree, w):
    """A dense mix both sides compute identically: float64 numpy, to fp32."""
    w = np.asarray(w, np.float64)
    return {k: (w @ np.asarray(x, np.float64).reshape(N, -1)).astype(np.float32)
            .reshape(x.shape) for k, x in tree.items()}


def _ctxs():
    """Two rounds' masks: dropout on nodes 2 and 6, then on node 4 only, and
    stragglers on top; W_t renormalized for the dropped nodes."""
    rng = np.random.default_rng(9)
    out = []
    for active in (ACTIVE, np.arange(N) != 4):
        lm = (rng.random((TAU - 1, N)) >= 0.3) & active[None, :]
        out.append((_w_dropout(active), active, lm))
    return out


SCHED_CASES = {name: (name, {}) for name in sorted(ALGORITHMS)}
SCHED_CASES.update({
    "dse_mvr_choco_overlap_top_k": ("dse_mvr", dict(
        compression="top_k:0.1", channel="choco", overlap=True)),
    "gt_hsgd_async_top_k": ("gt_hsgd", dict(compression="top_k:0.1", channel="async:3")),
    "dse_sgd_sync_qsgd": ("dse_sgd", dict(compression="qsgd")),
})


def _assert_state_close(got, want, where):
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name == "step":
            assert g == int(w), where
        elif f.name == "comp":
            assert (g is None) == (w is None), where
            if g is not None:
                for b, (gw, ww) in enumerate(zip(g.wire, w.wire)):
                    _assert_wire_close(gw, jax.tree.map(np.asarray, ww), f"{where} wire[{b}]")
        elif w is None:
            assert g is None, (where, f.name)
        else:
            for k, leaf in w.items():
                np.testing.assert_allclose(tree_to_numpy(g)[k], np.asarray(leaf), **STATE_TOL,
                                           err_msg=f"{where} {f.name}.{k}")


@pytest.mark.parametrize("case", sorted(SCHED_CASES))
def test_scheduled_rounds_match_reference(case):
    """Two scheduled rounds under dropout and straggler masks, from the same
    initial state and seeds: every buffer and the wire agree, the gated
    nodes' state included."""
    name, comm = SCHED_CASES[case]
    rng = np.random.default_rng(3)
    params, full = _np_tree(rng), _np_tree(rng)
    mbs = [[_np_tree(rng) for _ in range(TAU)] for _ in range(2)]
    kw = dict(lr=0.1, alpha=0.2, beta=0.3, tau=TAU, **comm)
    jalg, talg = j_registry_make(name, **kw), t_registry_make(name, **kw)
    rl = talg.comm.round_len(TAU)
    jfull = jax.tree.map(jnp.asarray, full)
    jfull_fn = lambda p: jax.tree.map(lambda x, c: x * 0.25 - c, p, jfull)  # noqa: E731
    tfull_fn = lambda p: {k: p[k] * 0.25 - torch.from_numpy(full[k]) for k in p}  # noqa: E731
    key = jax.random.key(21)
    jstate = j_attach(jalg, jalg.init(jax.tree.map(jnp.asarray, params), jfull_fn), key)
    tstate = attach_channel_state(talg, talg.init(params_from_numpy(params, "cpu"), tfull_fn))
    jstep, _ = j_make_round_step(
        jalg, lambda t, ctx: jax.tree.map(jnp.asarray, _np_mix_w(jax.tree.map(np.asarray, t),
                                                                   ctx.w)),
        lambda p, c: jax.tree.map(lambda x, ci: x * 0.5 + ci, p, c), full_grad_fn=jfull_fn,
        scheduled=True)
    tstep, trl = make_round_step(
        talg, lambda t, ctx: params_from_numpy(_np_mix_w(tree_to_numpy(t), ctx.w.numpy()), "cpu"),
        lambda p, c: {k: p[k] * 0.5 + c[k] for k in p}, full_grad_fn=tfull_fn,
        comm_seed_fn=ReferenceDraws(key, 2, 2, len(SHAPES)).seed_fn, scheduled=True)
    assert trl == rl
    for r, (w, active, lm) in enumerate(_ctxs()):
        jctx = JRoundCtx(w=jnp.asarray(w), active=jnp.asarray(active),
                         local_mask=jnp.asarray(lm), pattern=jnp.int32(0))
        tctx = RoundCtx(w=torch.from_numpy(w), active=torch.from_numpy(active),
                        local_mask=torch.from_numpy(lm), pattern=0)
        batch = mbs[r][:rl]
        jstate = jstep(jstate, {k: jnp.stack([jnp.asarray(m[k]) for m in batch]) for k in SHAPES},
                       jctx)
        before = tstate
        tstate = tstep(tstate, [params_from_numpy(m, "cpu") for m in batch], tctx)
        _assert_state_close(tstate, jstate, f"{case} round {r}")
        for k in SHAPES:   # a dropped node keeps its parameters
            np.testing.assert_array_equal(tstate.params[k][~active].numpy(),
                                          before.params[k][~active].numpy())


def test_select_nodes_walks_the_whole_state():
    """Node-stacked tensors anywhere in the state (wire and packed payloads
    included) are gated; ints, None and 0-d tensors take the new value; no
    mask returns ``new`` itself and an all-true mask ``new``'s values."""
    def state(fill):
        t = lambda *s: torch.full(s, float(fill))  # noqa: E731
        wire = ({"hat": {"w": t(N, 3)}, "age": torch.full((N,), fill, dtype=torch.int32)},
                {"fly": {"payload": {"w": Packed({"idx": torch.full((N, 2), fill),
                                                  "vals": t(N, 2)}, meta=((3,), fill))}}},
                None)
        return DSEState(params={"w": t(N, 3)}, x_ref={"w": t(N, 3)}, v=None, y={"a": t(N, 1)},
                        h_prev=(t(N), t(2, 5)), z=t(), step=fill,
                        comp=ChannelState(wire=wire, event=fill))

    new, old = state(1), state(0)
    assert _select_nodes(None, new, old) is new
    mask = torch.from_numpy(ACTIVE)
    out = _select_nodes(mask, new, old)
    assert out.step == 1 and out.comp.event == 1 and out.v is None
    assert float(out.z) == 1.0 and torch.equal(out.h_prev[1], new.h_prev[1])
    for got in (out.params["w"], out.x_ref["w"], out.y["a"], out.h_prev[0],
                out.comp.wire[0]["hat"]["w"], out.comp.wire[0]["age"],
                out.comp.wire[1]["fly"]["payload"]["w"].data["idx"],
                out.comp.wire[1]["fly"]["payload"]["w"].data["vals"]):
        assert got.reshape(N, -1)[:, 0].tolist() == ACTIVE.astype(float).tolist()
    assert out.comp.wire[1]["fly"]["payload"]["w"].meta == ((3,), 1)
    full = _select_nodes(torch.ones(N, dtype=torch.bool), new, old)
    assert torch.equal(full.params["w"], new.params["w"])
    assert torch.equal(full.comp.wire[0]["age"], new.comp.wire[0]["age"])


# -------------------------------------------------------------- channels
@pytest.mark.parametrize("trigger", [None, 0.5, -1.0, 0.0])
def test_async_trigger_override_matches_reference(trigger):
    """``ctx.trigger`` of 0 or more replaces the threshold for the round; a
    negative one keeps the channel's own (here 0.1)."""
    rng = np.random.default_rng(8)
    tree = _np_tree(rng)
    hat = {k: x + np.where(np.arange(N) < 4, 1e-2, 0.3).astype(np.float32).reshape(
        (N,) + (1,) * (x.ndim - 1)) * rng.standard_normal(x.shape).astype(np.float32)
        for k, x in tree.items()}
    wire = {"hat": hat, "age": np.array([3, 0, 1, 2, 0, 1, 2, 0], np.int32),
            "sent": np.zeros(N, bool)}
    w = ring(N).w
    jctx = JRoundCtx(w=jnp.asarray(w, jnp.float32),
                     trigger=None if trigger is None else jnp.float32(trigger))
    tctx = RoundCtx(w=torch.from_numpy(w.astype(np.float32)),
                    trigger=None if trigger is None else np.float32(trigger))
    jmix = lambda t, ctx: jax.tree.map(jnp.asarray, _np_mix_w(jax.tree.map(np.asarray, t),  # noqa
                                                              ctx.w))
    want_out, want_wire = JAsyncChannel(max_staleness=4, threshold=0.1).gossip(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, wire), jax.random.key(1),
        jctx, JTransport(jmix, scheduled=True))
    got_out, got_wire = AsyncChannel(max_staleness=4, threshold=0.1).gossip(
        params_from_numpy(tree, "cpu"), {k: params_from_numpy(v, "cpu") for k, v in wire.items()},
        lambda leaf: 0, Transport(lambda t, ctx: params_from_numpy(
            _np_mix_w(tree_to_numpy(t), ctx.w.numpy()), "cpu"), scheduled=True), tctx)
    _assert_wire_close(got_wire, jax.tree.map(np.asarray, want_wire), "wire")
    _assert_wire_close(got_out, jax.tree.map(np.asarray, want_out), "out")
    sent = got_wire["sent"].tolist()
    if trigger == 0.0:   # θ = 0 for the round: every node that drifted sends
        assert all(sent), sent
    else:                # node 0 is forced; the near replicas stay silent
        assert sent[0] and 0 < sum(sent) < N, sent


@pytest.mark.parametrize("scale", [1.0, 0.55, 0.1])
def test_sync_top_k_spends_the_round_scale_like_reference(scale):
    """A sync error-feedback top-k gossip under ``ctx.comp_scale`` keeps the
    reference's first ``ceil(scale * k)`` slots: payload, decode, residual and
    the mixed value agree."""
    rng = np.random.default_rng(2)
    tree, res = _np_tree(rng), _np_tree(rng, 0.01)
    w = ring(N).w.astype(np.float32)
    jctx = JRoundCtx(w=jnp.asarray(w), comp_scale=jnp.float32(scale))
    tctx = RoundCtx(w=torch.from_numpy(w), comp_scale=np.float32(scale))
    jmix = lambda t, ctx: jax.tree.map(jnp.asarray, _np_mix_w(jax.tree.map(np.asarray, t),  # noqa
                                                              ctx.w))
    want_out, want_wire = JSyncChannel().bind(j_make_compressor("top_k:0.1")).gossip(
        jax.tree.map(jnp.asarray, tree), {"res": jax.tree.map(jnp.asarray, res)},
        jax.random.key(1), jctx, JTransport(jmix, scheduled=True))
    got_out, got_wire = SyncChannel().bind(make_compressor("top_k:0.1")).gossip(
        params_from_numpy(tree, "cpu"), {"res": params_from_numpy(res, "cpu")}, lambda leaf: 0,
        Transport(lambda t, ctx: params_from_numpy(_np_mix_w(tree_to_numpy(t), ctx.w.numpy()),
                                                   "cpu"), scheduled=True), tctx)
    _assert_wire_close(got_wire, jax.tree.map(np.asarray, want_wire), "wire")
    _assert_wire_close(got_out, jax.tree.map(np.asarray, want_out), "out")


# ------------------------------------------------------------ full runs
RUNS = {
    "dropout_ring": ("dropout_ring", "dse_mvr", {}),
    "straggler_ring": ("straggler_ring", "dse_mvr", {}),
    "one_peer": ("one_peer", "dse_mvr", {}),
    "hetero_clients": ("hetero_clients", "dse_mvr", {}),
    "hostile": ("hostile", "dse_mvr", {}),
    "dropout_ring_gt_hsgd": ("dropout_ring", "gt_hsgd", {}),
    "warmup_compress_top_k": ("warmup_compress", "dse_mvr", dict(compression="top_k:0.1")),
    "async_lossy_async3": ("async_lossy", "dse_mvr", dict(channel="async:3")),
}


@functools.lru_cache(maxsize=None)
def _run_pair(case):
    """(reference out, port out, band) of ``Simulator.run`` under the case's
    scenario, from the same indices, initial parameters and codec keys."""
    scen, name, comm = RUNS[case]
    steps = 64 if comm else 66
    band = (CODEC_RTOL, CODEC_ACC_TOL) if comm else (RUN_RTOL, ACC_TOL)
    data, (xte, yte) = jcommon.make_paper_problem(OMEGA, seed=SEED)
    jalg = jcommon.make_algorithm(name, 0.3, TAU, steps, **comm)
    jsim = JSimulator(jalg, None, jcommon.mlp_loss, data, B, scenario=j_make_scenario(scen),
                      eval_fn=lambda p: {"test_acc": jcommon.accuracy(p, xte, yte)})
    want = jsim.run(jcommon.mlp_init(jax.random.key(SEED)), jax.random.key(SEED + 1), steps,
                    eval_every=32)
    want = dict(want, streams={k: np.asarray(v) for k, v in want["streams"].items()})

    tdata, (txe, tye) = tproblem.make_paper_problem(OMEGA, seed=SEED)
    idx = _reference_indices(jax.random.key(SEED + 1), steps, N, B, tdata.samples_per_node)
    talg = tproblem.make_algorithm(name, 0.3, TAU, steps, use_fused=True, **comm)
    seed_fn = None
    if comm:
        seed_fn = ReferenceDraws(jax.random.fold_in(jax.random.key(SEED + 1), CHANNEL_TAG),
                                 steps // TAU, 2, 4).seed_fn
    xt, yt = torch.as_tensor(txe), torch.as_tensor(tye).long()
    tsim = Simulator(talg, None, tproblem.mlp_loss, tdata, B,
                     eval_fn=lambda p: {"test_acc": tproblem.accuracy(p, xt, yt)},
                     scenario=make_scenario(scen), device="cpu",
                     index_fn=lambda s: idx[s], comm_seed_fn=seed_fn)
    got = tsim.run(_reference_init(SEED), steps, eval_every=32)
    return want, got, band


@pytest.mark.parametrize("case", sorted(RUNS))
def test_run_history_matches_reference(case):
    want, got, (rtol, acc_tol) = _run_pair(case)
    assert [h["step"] for h in got["history"]] == [h["step"] for h in want["history"]]
    for g, w in zip(got["history"], want["history"]):
        for k in ("train_loss", "grad_norm_sq", "consensus"):
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=RUN_ATOL,
                                       err_msg=f"step {w['step']} {k}")
        assert abs(g["test_acc"] - w["test_acc"]) <= acc_tol, w["step"]
    assert got["state"].step == int(want["state"].step)


@pytest.mark.parametrize("case", sorted(RUNS))
def test_run_streams_and_schedule_match_reference(case):
    want, got, (rtol, _) = _run_pair(case)
    assert list(got["streams"]) == list(STREAM_FIELDS)
    for k in STREAM_FIELDS:
        g, w = got["streams"][k], want["streams"][k]
        assert isinstance(g, np.ndarray) and g.dtype == np.float32 and g.shape == w.shape, k
        if k == "active_nodes":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=RUN_ATOL, err_msg=k)
    for f in dataclasses.fields(want["schedule"]):
        a, b = getattr(got["schedule"], f.name), getattr(want["schedule"], f.name)
        assert (a is None) == (b is None), f.name
        if b is not None:
            np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_batch_sizes_tile_the_drawn_indices():
    """Per-node batch sizes keep b slots and tile node i's first b_i draws
    cyclically, as the reference's ``NodeData.sample`` does."""
    data, _ = tproblem.make_paper_problem(OMEGA, seed=SEED)
    idx = torch.randint(0, data.samples_per_node, (N, B), generator=torch.Generator().manual_seed(0))
    sim = Simulator(t_registry_make("dse_mvr", lr=0.1, tau=TAU), None, tproblem.mlp_loss, data, B,
                    scenario=make_scenario("hetero_clients"), device="cpu",
                    index_fn=lambda s: idx)
    sched = sim.scenario.materialize(N, 4, 1, batch_size=B)
    _, slots = sim._device_schedule(sched)
    x, y = sim._batch(0, slots)
    for i, b_i in enumerate(sched.batch_sizes):
        want = idx[i, :b_i].repeat(B)[:B]
        assert torch.equal(y[i], torch.as_tensor(data.y[i])[want].long())
        assert torch.equal(x[i], torch.as_tensor(data.x[i])[want])
    assert sched.batch_sizes.min() < B


# ----------------------------------------------------- baseline and errors
@pytest.mark.parametrize("case", sorted(ALGORITHMS) + ["dse_mvr_choco_top_k"])
def test_baseline_scenario_is_the_static_ring_bit_for_bit(case):
    """The static, fault-free scenario runs exactly the static executor's
    operations: equal states, history and kernel dispatch counts."""
    name, comm = ("dse_mvr", dict(channel="choco", compression="top_k:0.1")) \
        if case == "dse_mvr_choco_top_k" else (case, {})
    data, _ = tproblem.make_paper_problem(OMEGA, seed=SEED)
    outs = []
    for scenario in (None, make_scenario("baseline")):
        alg = tproblem.make_algorithm(name, 0.3, TAU, 24, use_fused=True, **comm)
        sim = Simulator(alg, ring(N), tproblem.mlp_loss, data, B, scenario=scenario,
                        device="cpu", seed=7)
        tapi.reset_counters()
        out = sim.run(tproblem.mlp_init(1), 22, eval_every=8)
        outs.append((out, tapi.call_counts()))
    (a, ca), (b, cb) = outs
    assert ca == cb and (not comm or ca)
    assert a["history"] == b["history"]
    sa, sb = a["state"], b["state"]
    for f in dataclasses.fields(sa):
        x, y = getattr(sa, f.name), getattr(sb, f.name)
        if isinstance(x, dict):
            assert all(torch.equal(x[k], y[k]) for k in x), f.name
        elif f.name == "comp" and x is not None:
            assert all(torch.equal(p, q) for wa, wb in zip(x.wire, y.wire)
                       for p, q in zip(wa["hat"].values(), wb["hat"].values()))
        else:
            assert x == y or (x is None and y is None), f.name
    assert b["streams"]["spectral_gap"].shape == (22 // sim.round_len,)


def test_streams_do_not_touch_the_run():
    """``stream_metrics=False`` returns no streams and the same run, bit for
    bit: the streams read the state and change nothing."""
    data, _ = tproblem.make_paper_problem(OMEGA, seed=SEED)
    outs = []
    for streams in (True, False):
        sim = Simulator(tproblem.make_algorithm("dse_mvr", 0.3, TAU, 10), None,
                        tproblem.mlp_loss, data, B, scenario=make_scenario("hostile"),
                        stream_metrics=streams, device="cpu", seed=2)
        outs.append(sim.run(tproblem.mlp_init(0), 10, eval_every=4))
    assert list(outs[0]["streams"]) == list(STREAM_FIELDS) and outs[1]["streams"] == {}
    assert outs[0]["history"] == outs[1]["history"]
    for k, leaf in outs[0]["state"].params.items():
        assert torch.equal(leaf, outs[1]["state"].params[k]), k


def test_topology_must_match_the_scenario():
    data, _ = tproblem.make_paper_problem(OMEGA, seed=SEED)
    alg = tproblem.make_algorithm("dse_mvr", 0.3, TAU, 8)
    for bad in (torus(2, 4), ring(N)):
        scen = "baseline" if bad.name != "ring" else "torus"
        with pytest.raises(ValueError, match="disagrees"):
            Simulator(alg, bad, tproblem.mlp_loss, data, B, scenario=make_scenario(scen),
                      device="cpu")
    with pytest.raises(ValueError, match="topology, a scenario"):
        Simulator(alg, None, tproblem.mlp_loss, data, B, device="cpu")
    sim = Simulator(alg, ring(N), tproblem.mlp_loss, data, B, device="cpu",
                    scenario=make_scenario("dropout_ring"))   # round 0 before faults: a ring
    scen_only = Simulator(alg, None, tproblem.mlp_loss, data, B, device="cpu",
                          scenario=make_scenario("dropout_ring"))
    with pytest.raises(ValueError, match="no static topology"):
        scen_only.run_rounds(scen_only.init_state(tproblem.mlp_init(0)), 1)
    assert sim.round_len == scen_only.round_len == TAU


def test_straggler_scenario_on_every_step_algorithm_warns():
    data, _ = tproblem.make_paper_problem(OMEGA, seed=SEED)
    alg = tproblem.make_algorithm("dsgd", 0.3, TAU, 8)
    with pytest.warns(RuntimeWarning, match="degenerates to its fault-free variant"):
        Simulator(alg, None, tproblem.mlp_loss, data, B, device="cpu",
                  scenario=make_scenario("straggler_ring"))
    with pytest.warns(RuntimeWarning, match="round-level faults still do"):
        Simulator(alg, None, tproblem.mlp_loss, data, B, device="cpu",
                  scenario=make_scenario("hostile"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        Simulator(tproblem.make_algorithm("dse_mvr", 0.3, TAU, 8), None, tproblem.mlp_loss,
                  data, B, device="cpu", scenario=make_scenario("straggler_ring"))


def test_scenario_simulator_needs_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    data, _ = tproblem.make_paper_problem(OMEGA, seed=SEED)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulator(tproblem.make_algorithm("dse_mvr", 0.3, TAU, 8), None, tproblem.mlp_loss,
                  data, B, scenario=make_scenario("dropout_ring"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tproblem.run_method("dse_mvr", OMEGA, TAU, B, 8, scenario=make_scenario("one_peer"))


def test_dropped_scenario_simulator_is_freed_without_the_garbage_collector():
    """The scheduled executor and the stream function close over the loss
    and the data, not over the Simulator: after a scenario run, dropping it
    frees its copies of the data at once."""
    import gc
    import weakref

    from repro_torch.core import NodeData

    rng = np.random.default_rng(0)
    data = NodeData(rng.normal(size=(4, 16, tproblem.DIM)).astype(np.float32),
                    rng.integers(0, tproblem.CLASSES, (4, 16)).astype(np.int32))
    alg = tproblem.make_algorithm("dse_mvr", 0.3, 2, 8, compression="top_k:0.1")
    gc.collect()
    gc.disable()
    try:
        sim = Simulator(alg, None, tproblem.mlp_loss, data, 4, device="cpu",
                        scenario=make_scenario("hostile"))
        out = sim.run(tproblem.mlp_init(0, hidden=8), 8, eval_every=4)
        assert out["streams"]["consensus"].shape == (4,)
        refs = [weakref.ref(t) for t in (sim, sim._x, sim._y) + sim._full_flat]
        del sim, out
        assert all(ref() is None for ref in refs)
    finally:
        gc.enable()
