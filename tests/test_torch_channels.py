"""The port's CHOCO, async and per-buffer gossip channels, and overlap,
against the reference's (``repro.compression.channels``).

Randomness is replayed as in ``test_torch_compression.py``: the reference's
per-leaf codec keys are rebuilt from its channel key and handed to the port
as uint32 seeds (``comm_seed_fn``).  Top-k needs no randomness, so equal
inputs select equal indices.

Tolerances:
  * one or two communication rounds from the same state, wire state and
    seeds, with a dense mix both sides compute in float64 numpy: rtol 1e-5 /
    atol 1e-6 on every buffer and on the wire (replicas, residuals, the
    in-flight payload's values); indices, ages and send masks exactly;
  * ``async:1`` with no codec against the uncompressed run: bit for bit (the
    executor takes the same path);
  * 64-step ``run_method`` against the reference: the compressed band of
    ``test_torch_compression.py`` (rtol 5e-3 / atol 1e-5 on ``train_loss``
    and ``consensus``, 5/1000 on ``test_acc``).  Top-k is discontinuous:
    where an ulp of XLA's and ATen's GEMMs lands on a near-tie of the k-th
    and (k+1)-th magnitude, the two sides keep different entries, and error
    feedback or the replica carries the swap on.  Measured on a CPU (this
    file's printout): 1e-7 relative for sync+EF top-k, 1.1e-3 on
    ``consensus`` for CHOCO top-k, whose first swap comes at event 8 of 16,
    and 1.6e-7 for rand-k.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common as jcommon
from repro.compression import AsyncChannel as JAsyncChannel
from repro.compression import ChannelState as JChannelState
from repro.compression import ChocoChannel as JChocoChannel
from repro.compression import PerBufferChannel as JPerBufferChannel
from repro.compression import Transport as JTransport
from repro.compression import attach_channel_state as j_attach
from repro.compression import compression_error as j_compression_error
from repro.compression import make_compressor as j_make_compressor
from repro.core import CommSpec as JCommSpec
from repro.core import make_algorithm as j_registry_make
from repro.core.algorithm import make_round_step as j_make_round_step
from repro_torch import paper_problem as tproblem
from repro_torch.compression import (
    AsyncChannel, ChocoChannel, ErrorFeedback, Packed, PerBufferChannel, RandK, SyncChannel,
    Transport, attach_channel_state, compression_error, make_compressor,
)
from repro_torch.convert import params_from_numpy, state_from_numpy, tree_to_numpy
from repro_torch.core import CommSpec, Simulator, ring
from repro_torch.core import make_algorithm as t_registry_make
from repro_torch.core.algorithm import make_round_step
from repro_torch.kernels import api as tapi
from test_torch_compression import CHANNEL_TAG, ReferenceDraws, _reference_like
from test_torch_simulator import _reference_indices, _reference_init

STATE_TOL = dict(rtol=1e-5, atol=1e-6)
N, B, TAU, OMEGA, SEED = 8, 16, 4, 0.5, 0
SHAPES = {"b": (N, 7), "w": (N, 12, 10)}
W = ring(N).w.astype(np.float64)
BUFFERS = ("y", "params")

# name -> (reference channel, port channel, compression, rounds)
CONFIGS = {
    "choco_top_k": ("choco", "choco", "top_k:0.1", 1),
    "choco0.8_top_k": ("choco:0.8", "choco:0.8", "top_k:0.1", 1),
    "choco_raw": ("choco", "choco", None, 1),
    "async_top_k": (JAsyncChannel(max_staleness=4, threshold=0.5),
                    AsyncChannel(max_staleness=4, threshold=0.5), "top_k:0.1", 1),
    "async_raw": (JAsyncChannel(max_staleness=4, threshold=0.1),
                  AsyncChannel(max_staleness=4, threshold=0.1), None, 1),
    "per_buffer_top_k": ({"params": "choco"}, {"params": "choco"}, "top_k:0.1", 1),
    "choco_overlap_top_k": (JChocoChannel(overlap=True), ChocoChannel(overlap=True),
                            "top_k:0.1", 2),
    "async_overlap_top_k": (JAsyncChannel(max_staleness=2, threshold=0.5, overlap=True),
                            AsyncChannel(max_staleness=2, threshold=0.5, overlap=True),
                            "top_k:0.1", 2),
}


def _np_mix(tree):
    """A dense mix both sides compute identically: float64 numpy, to fp32."""
    return {k: (W @ np.asarray(x, np.float64).reshape(N, -1)).astype(np.float32)
            .reshape(x.shape) for k, x in tree.items()}


def _np_tree(rng, scale=1.0):
    return {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}


def _near(rng, tree):
    """A replica close to ``tree`` on nodes 0-3 (little drift: no triggered
    send) and far on nodes 4-7."""
    eps = np.where(np.arange(N) < 4, 1e-2, 1.0).astype(np.float32)
    return {k: x + eps.reshape((N,) + (1,) * (x.ndim - 1)) * rng.standard_normal(x.shape)
            .astype(np.float32) for k, x in tree.items()}


def _start_wire(jalg, fields, rng, fresh):
    """The reference's wire layout for this spec, filled with a replica near
    each buffer, mixed ages and send masks (or left as initialized)."""
    zeros = {k: jnp.zeros(s) for k, s in SHAPES.items()}
    wire = j_attach(jalg, jalg.init(zeros), jax.random.key(0)).comp.wire
    wire = jax.tree.map(np.asarray, wire)
    if fresh:
        return wire
    out = []
    for name, w in zip(BUFFERS, wire):
        w = dict(w)
        if "hat" in w:
            w["hat"] = _near(rng, fields[name])
        if "res" in w:
            w["res"] = _np_tree(rng, 0.01)
        if "age" in w:
            w["age"] = np.array([3, 0, 1, 2, 0, 1, 2, 3], np.int32)
            w["sent"] = np.arange(N) % 2 == 0
        out.append(w)
    return tuple(out)


def _rounds(config, seed=0):
    """The reference's and the port's states after the config's rounds of
    DSE-MVR (tau = 1) from the same state, wire and seeds."""
    jchan, tchan, comp, n_rounds = CONFIGS[config]
    rng = np.random.default_rng(seed)
    fields = dict(params=_np_tree(rng), x_ref=_np_tree(rng), v=_np_tree(rng, 0.5),
                  y=_np_tree(rng, 0.1), h_prev=_np_tree(rng, 0.1))
    mb, full = _np_tree(rng), _np_tree(rng)
    kw = dict(lr=0.1, alpha=0.2, tau=1, compression=comp)
    jalg = j_registry_make("dse_mvr", channel=jchan, **kw)
    talg = t_registry_make("dse_mvr", channel=tchan, **kw)
    wire = _start_wire(jalg, fields, rng, fresh=n_rounds > 1)
    step, key = 3, jax.random.key(21)
    jstate = type(jalg.init({k: jnp.zeros(s) for k, s in SHAPES.items()}))(
        **{k: jax.tree.map(jnp.asarray, v) for k, v in fields.items()}, z=None,
        step=jnp.int32(step), comp=JChannelState(wire=jax.tree.map(jnp.asarray, wire), key=key))
    tstate = state_from_numpy(_reference_like("DSEState", dict(fields, z=None),
                                              step=np.int32(step),
                                              comp=JChannelState(wire=wire, key=key)), "cpu")

    jmix = lambda t: jax.tree.map(jnp.asarray, _np_mix(jax.tree.map(np.asarray, t)))  # noqa: E731
    tmix = lambda t: params_from_numpy(_np_mix(tree_to_numpy(t)), "cpu")  # noqa: E731
    jfull = jax.tree.map(jnp.asarray, full)
    jstep, _ = j_make_round_step(
        jalg, jmix, lambda p, c: jax.tree.map(lambda x, ci: x * 0.5 + ci, p, c),
        full_grad_fn=lambda p: jax.tree.map(lambda x, ci: x * 0.25 - ci, p, jfull))
    tstep, _ = make_round_step(
        talg, tmix, lambda p, c: {k: p[k] * 0.5 + c[k] for k in p},
        full_grad_fn=lambda p: {k: p[k] * 0.25 - torch.from_numpy(full[k]) for k in p},
        comm_seed_fn=ReferenceDraws(key, n_rounds, 2, len(SHAPES)).seed_fn,
    )
    jbatch = jax.tree.map(lambda c: jnp.asarray(c)[None], mb)
    states = []
    for _ in range(n_rounds):
        jstate = jstep(jstate, jbatch)
        tstate = tstep(tstate, [params_from_numpy(mb, "cpu")])
        states.append((jstate, tstate))
    return states


def _assert_wire_close(got, want, where):
    """One buffer's wire: trees within STATE_TOL, integer and bool leaves and
    payload indices exactly, payload metadata equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (where, got, want)
        for k in want:
            _assert_wire_close(got[k], want[k], f"{where}.{k}")
    elif type(want).__name__ == "Packed":
        assert isinstance(got, Packed), where
        assert got.meta[0] == want.meta[0] and got.meta[2:] == want.meta[2:], where
        assert str(got.meta[1]) == f"torch.{want.meta[1]}", where
        _assert_wire_close(got.data, want.data, f"{where}.data")
    else:
        g, w = tree_to_numpy(got), np.asarray(want)
        if w.dtype.kind in "biu":
            assert g.dtype == w.dtype, (where, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=where)
        else:
            np.testing.assert_allclose(g, w.astype(np.float32), **STATE_TOL, err_msg=where)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_comm_rounds_match_reference(config):
    """DSE-MVR's communication rounds through each channel from the same
    state, wire state and seeds: the whole state tree agrees, wire included."""
    for r, (want, got) in enumerate(_rounds(config)):
        assert got.step == int(want.step) and got.comp.event == r + 1
        for field in ("params", "x_ref", "v", "y", "h_prev"):
            for k, w in getattr(want, field).items():
                np.testing.assert_allclose(tree_to_numpy(getattr(got, field))[k], np.asarray(w),
                                           **STATE_TOL, err_msg=f"round {r} {field}.{k}")
        assert got.z is None and want.z is None
        assert len(got.comp.wire) == len(want.comp.wire) == 2
        for b in range(2):
            _assert_wire_close(got.comp.wire[b], want.comp.wire[b], f"round {r} wire[{b}]")


@pytest.mark.parametrize("comp", [None, "top_k:0.1"])
def test_async_gossip_gates_replicas_by_the_trigger(comp):
    """One async gossip against the reference's, with a replica near the
    value on nodes 0-3 and far on nodes 4-7, and node 0 at the age bound:
    node 0 is forced, nodes 4-7 drift past the threshold, nodes 1-3 stay
    silent; the replicas, ages and the mixed value agree."""
    rng = np.random.default_rng(8)
    tree = _np_tree(rng)
    wire = {"hat": _near(rng, tree), "age": np.array([3, 0, 1, 2, 0, 1, 2, 3], np.int32),
            "sent": np.zeros(N, bool)}
    key = jax.random.key(5)
    jchan = JAsyncChannel(max_staleness=4, threshold=0.1).bind(
        None if comp is None else j_make_compressor(comp))
    tchan = AsyncChannel(max_staleness=4, threshold=0.1).bind(
        None if comp is None else make_compressor(comp))
    jmix = lambda t: jax.tree.map(jnp.asarray, _np_mix(jax.tree.map(np.asarray, t)))  # noqa: E731
    want_out, want_wire = jchan.gossip(jax.tree.map(jnp.asarray, tree),
                                       jax.tree.map(jnp.asarray, wire), key, None,
                                       JTransport(jmix))
    draws = ReferenceDraws(key, 0, 0, 0)
    got_out, got_wire = tchan.gossip(
        params_from_numpy(tree, "cpu"), {k: params_from_numpy(v, "cpu") for k, v in wire.items()},
        lambda leaf: draws.add(jax.random.fold_in(key, leaf)),
        Transport(lambda t: params_from_numpy(_np_mix(tree_to_numpy(t)), "cpu")))
    assert got_wire["sent"].tolist() == [True, False, False, False, True, True, True, True]
    np.testing.assert_array_equal(got_wire["age"].numpy(), [0, 1, 2, 3, 0, 0, 0, 0])
    _assert_wire_close(got_wire, jax.tree.map(np.asarray, want_wire), "wire")
    _assert_wire_close(got_out, jax.tree.map(np.asarray, want_out), "out")
    for k in SHAPES:   # silent nodes keep their replica rows
        np.testing.assert_array_equal(got_wire["hat"][k][1:4].numpy(), wire["hat"][k][1:4])


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_init_wire_matches_reference(config):
    """``attach_channel_state`` builds the reference's wire layout per buffer:
    zero replicas, int32 ages, bool masks and, with overlap, a zero payload
    of the codec's packed structure."""
    jchan, tchan, comp, _ = CONFIGS[config]
    zeros = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    jalg = j_registry_make("dse_mvr", lr=0.1, tau=1, compression=comp, channel=jchan)
    talg = t_registry_make("dse_mvr", lr=0.1, tau=1, compression=comp, channel=tchan)
    want = j_attach(jalg, jalg.init(jax.tree.map(jnp.asarray, zeros)), jax.random.key(0))
    got = attach_channel_state(talg, talg.init(params_from_numpy(zeros, "cpu")))
    assert got.comp.event == 0
    for b in range(2):
        _assert_wire_close(got.comp.wire[b], jax.tree.map(np.asarray, want.comp.wire[b]),
                           f"wire[{b}]")
    assert bool(torch.isnan(compression_error(got))) == bool(jnp.isnan(
        j_compression_error(want)))


def test_choco_drops_error_feedback_and_is_not_a_pass_through():
    """Choco's bind strips the error-feedback default (no ``res`` wire, NaN
    compression error); with no codec it still runs the replica algebra."""
    for choco, comp in ((ChocoChannel, make_compressor("top_k:0.1")),
                        (JChocoChannel, j_make_compressor("top_k:0.1"))):
        bound = choco().bind(comp)
        assert not isinstance(bound.compression, type(comp)) and bound.compression is comp.inner
        assert not choco().is_passthrough
        assert bound.tag == "choco_top_k0.1"
    spec = CommSpec(compression="top_k:0.1", channel="choco")
    assert spec.resolved_channel().compression == make_compressor("top_k:0.1").inner
    assert CommSpec(channel="choco").resolved_channel() is not None
    assert CommSpec(channel="async:1").resolved_channel() is None
    assert CommSpec(channel="async:1", compression="top_k:0.1").resolved_channel() is not None
    assert CommSpec(channel={"params": "sync"}).resolved_channel() is None


def test_async_bound_one_is_sync_bit_for_bit():
    """``async:1`` with no codec is the plain path (the executor never builds a
    session); inside a session its gossip is the plain mix itself."""
    outs = [tproblem.run_method("dse_mvr", OMEGA, TAU, B, 16, device="cpu", channel=c)
            for c in (None, "async:1")]
    for k in ("train_loss", "consensus", "test_acc"):
        assert outs[0][k] == outs[1][k], k
    tree = params_from_numpy(_np_tree(np.random.default_rng(1)), "cpu")
    transport = Transport(lambda t: params_from_numpy(_np_mix(tree_to_numpy(t)), "cpu"))
    mixed, wire = AsyncChannel(max_staleness=1).gossip(tree, None, lambda leaf: 0, transport)
    plain, none = SyncChannel().gossip(tree, None, lambda leaf: 0, transport)
    assert none is None and wire["hat"] is tree
    assert bool(wire["sent"].all()) and not bool(wire["age"].any())
    for k in SHAPES:
        assert torch.equal(mixed[k], plain[k])


def test_overlap_and_per_buffer_specs_raise_like_the_reference():
    bad = (
        dict(overlap=True),                                    # no channel
        dict(overlap=True, channel="sync"),
        dict(overlap=True, channel="sync", compression="qsgd"),
        dict(overlap=True, channel={"params": "choco"}),       # y stays sync
        dict(channel={"nope": "choco"}),
        dict(channel={"params": "nope"}),
        dict(channel="choco:0"),
        dict(channel="choco:1.5"),
        dict(channel="async:0"),
        dict(channel="sync:3"),
    )
    for kw in bad:
        with pytest.raises(ValueError):
            JCommSpec(buffers=BUFFERS, **kw)
        with pytest.raises(ValueError):
            CommSpec(buffers=BUFFERS, **kw)
    for mod in ((AsyncChannel, ChocoChannel, PerBufferChannel),
                (JAsyncChannel, JChocoChannel, JPerBufferChannel)):
        async_, choco, per_buffer = mod
        for make in (lambda: async_(max_staleness=1, overlap=True),
                     lambda: async_(threshold=-0.1),
                     lambda: choco(defer_roll=True),
                     lambda: per_buffer(channels=()),
                     lambda: per_buffer(channels=(per_buffer(channels=(choco(),)),))):
            with pytest.raises(ValueError):
                make()
        pb = per_buffer(channels=(choco(), async_()))
        with pytest.raises(ValueError):
            pb.init_wire({"w": jnp.zeros((N, 3))})
        with pytest.raises(ValueError):
            pb.for_buffer(2)
    # overlap turns every buffer's choco/async channel into its overlapped form
    for spec in (CommSpec(buffers=BUFFERS, channel="choco", overlap=True),
                 JCommSpec(buffers=BUFFERS, channel="choco", overlap=True)):
        assert spec.channel.overlap
    both = {"y": "async:3", "params": "choco"}
    got = CommSpec(buffers=BUFFERS, channel=both, overlap=True).channel
    want = JCommSpec(buffers=BUFFERS, channel=both, overlap=True).channel
    assert [c.overlap for c in got.channels] == [c.overlap for c in want.channels] == [True] * 2
    assert got.tag == want.tag == "async+choco"
    assert CommSpec(buffers=BUFFERS, channel={"params": "choco"}).channel.tag == \
        JCommSpec(buffers=BUFFERS, channel={"params": "choco"}).channel.tag == "sync+choco"


def test_sharded_engine_options_raise_not_implemented():
    """The sharded engine's wire modes and transport hooks are ROADMAP queue 1
    item 8; asking for them raises and says so."""
    for make in (lambda: ChocoChannel(neighbor_shifts=(1, -1)),
                 lambda: ChocoChannel(replicated_wire=True),
                 lambda: AsyncChannel(overlap=True, defer_roll=True),
                 lambda: Transport(lambda t: t, neighbor=object()),
                 lambda: Transport(lambda t: t, gather_payload=lambda p: p),
                 lambda: Transport(lambda t: t, run_local=lambda f: f),
                 lambda: tproblem.make_algorithm("dse_mvr", 0.3, 4, 8,
                                                 channel=ChocoChannel(replicated_wire=True))):
        with pytest.raises(NotImplementedError, match="queue 1 item 8"):
            make()


def test_choco_top_k_event_dispatches_eight_packs_and_unpacks():
    """A CHOCO top-k (and an overlapped one) DSE-MVR event on the MLP: 8
    pack and 8 unpack dispatches (4 leaves x 2 buffers), no launch on the
    CPU."""
    data, _ = tproblem.make_paper_problem(OMEGA, seed=SEED)
    for channel in ("choco", ChocoChannel(overlap=True)):
        alg = tproblem.make_algorithm("dse_mvr", 0.3, TAU, 8, channel=channel,
                                      compression="top_k:0.1")
        sim = Simulator(alg, ring(N), tproblem.mlp_loss, data, B, device="cpu")
        tapi.reset_counters()
        state = sim.init_state(tproblem.mlp_init(0))
        # the overlapped wire's zero payload: one plain encode on the CPU
        assert tapi.call_counts() == ({} if channel == "choco" else {"top_k_pack": 8})
        tapi.reset_counters()
        state = sim.run_rounds(state, 2)
        counts = tapi.call_counts()
        assert counts == {"top_k_pack": 16, "top_k_unpack": 16}, counts
        assert state.comp.event == 2 and tapi.launch_counts() == {}


def _reference_run(steps, channel=None, compression=None, tchannel=None, tcompression=None):
    """``run_method`` of the reference and of the port on the CPU, from the
    same indices, initial parameters and codec keys."""
    want = jcommon.run_method("dse_mvr", OMEGA, TAU, B, steps, seed=SEED, channel=channel,
                              compression=compression)
    data, _ = tproblem.make_paper_problem(OMEGA, seed=SEED)
    idx = _reference_indices(jax.random.key(SEED + 1), steps, N, B, data.samples_per_node)
    draws = ReferenceDraws(jax.random.fold_in(jax.random.key(SEED + 1), CHANNEL_TAG),
                           steps // TAU, 2, 4)
    if callable(tcompression):
        tcompression = tcompression(draws)
    got = tproblem.run_method(
        "dse_mvr", OMEGA, TAU, B, steps, seed=SEED, device="cpu",
        channel=channel if tchannel is None else tchannel,
        compression=compression if tcompression is None else tcompression,
        index_fn=lambda s: idx[s], init_params=_reference_init(SEED), comm_seed_fn=draws.seed_fn,
    )
    print("relative gap:", {k: abs(got[k] - want[k]) / abs(want[k])
                            for k in ("train_loss", "consensus", "test_acc")})
    for k in ("train_loss", "consensus"):
        np.testing.assert_allclose(got[k], want[k], rtol=5e-3, atol=1e-5, err_msg=k)
    assert abs(got["test_acc"] - want["test_acc"]) <= 5e-3


@pytest.mark.parametrize("case", ["choco_top_k", "sync_ef_top_k", "sync_ef_rand_k"])
def test_run_method_matches_reference(case):
    """64 steps of DSE-MVR with compressed gossip against the reference (the
    band and its reason are in the module docstring)."""
    if case == "choco_top_k":
        _reference_run(64, channel="choco", compression="top_k:0.1")
    elif case == "sync_ef_top_k":
        _reference_run(64, compression="top_k:0.1")
    else:
        _reference_run(64, compression="rand_k:0.25", tcompression=lambda draws: ErrorFeedback(
            inner=RandK(0.25, index_draw=draws.index_draw)))
