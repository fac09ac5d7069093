"""The port's gossip compression (``repro_torch.compression``) against the
reference (``repro.compression``), on the same numpy inputs.

Randomness is injected: the reference derives each leaf's codec key by
``fold_in(run_key, 0x636F)``, one ``split`` per communication event,
``fold_in(buffer)`` and ``fold_in(leaf)``; its noise hash reads
``key_data[0] ^ key_data[-1]``.  These tests replay that chain with JAX and
hand the port the resulting uint32 seeds through ``comm_seed_fn``.

Tolerances:
  * ``_hash_uniform``: bit for bit;
  * TopK and RandK on equal inputs: indices equal (order included) and
    values bit for bit -- a stable sort and a gather, no arithmetic;
  * LowRank, with the reference's sketch injected: the decoded tensor
    within rtol 1e-5 / atol 1e-6 (the QR's column signs may differ between
    LAPACK and XLA, ``P Pᵀ M`` does not, and the two GEMM orders round
    differently);
  * QSGD on the same inputs: the scale exactly; the int8 payload with at
    most 1e-4 of its elements off, each by one level (measured: none; the
    quantize rounds its product and sum separately on both sides);
  * one compressed communication round from the same state, with a dense
    mix and gradients both sides compute in the same IEEE steps: rtol 1e-5
    / atol 1e-6 on every buffer and residual;
  * ``run_method(..., compression="qsgd")`` after 64 steps: see
    ``test_run_method_qsgd_matches_reference``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common as jcommon
from repro.compression import ChannelSession as JChannelSession
from repro.compression import ChannelState as JChannelState
from repro.compression import SyncChannel as JSyncChannel
from repro.compression import Transport as JTransport
from repro.compression import make_compressor as j_make_compressor
from repro.compression.channels import link_bytes_per_round as j_link_bytes
from repro.compression.compressors import QSGD as JQSGD
from repro.compression.compressors import LowRank as JLowRank
from repro.compression.compressors import RandK as JRandK
from repro.compression.compressors import TopK as JTopK
from repro.compression.compressors import _hash_uniform as j_hash_uniform
from repro.core import CommSpec as JCommSpec
from repro.core import make_algorithm as j_registry_make
from repro.core.algorithm import make_round_step as j_make_round_step
from repro_torch import paper_problem as tproblem
from repro_torch.compression import (
    COMPRESSORS, QSGD, ChannelSession, ChannelState, ErrorFeedback, Identity, LowRank,
    Packed, RandK, SyncChannel, TopK, Transport, attach_channel_state, compression_error,
    link_bytes_per_round, make_compressor,
)
from repro_torch.compression.compressors import _hash_uniform
from repro_torch.convert import params_from_numpy, state_from_numpy, tree_to_numpy
from repro_torch.core import ALGORITHMS, CommSpec, Simulator, ring
from repro_torch.core import make_algorithm as t_registry_make
from repro_torch.core.algorithm import make_round_step
from repro_torch.kernels import api as tapi
from test_torch_simulator import _reference_indices, _reference_init

STATE_TOL = dict(rtol=1e-5, atol=1e-6)
N, B, TAU, OMEGA, SEED = 8, 16, 4, 0.5, 0
FLIP_BUDGET = 1e-4
CHANNEL_TAG = 0x636F


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's many small ops: beside other
    test workers, a pool of one OpenMP thread per core oversubscribes the
    CPU and spins, which slows these runs by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seed_of(key) -> int:
    """The uint32 the reference's noise hash reads from a typed key."""
    d = np.asarray(jax.random.key_data(key)).astype(np.uint32).reshape(-1)
    return int(d[0] ^ d[-1])


class ReferenceDraws:
    """The reference's per-leaf codec keys, replayed from the channel key
    (the Simulator's is ``fold_in(run_key, 0x636F)``): ``seed_fn`` is the
    port's ``comm_seed_fn`` (the uint32 each key's noise hash reads), and
    ``index_draw`` / ``sketch_draw`` are the draws rand-k and low-rank make
    from the key behind a seed, for injection into the port's codecs."""

    def __init__(self, chan_key, n_events, n_buffers, n_leaves):
        k = chan_key
        self.seeds, self.keys = {}, {}
        for e in range(n_events):
            use, k = jax.random.split(k)
            for b in range(n_buffers):
                kb = jax.random.fold_in(use, b)
                for leaf in range(n_leaves):
                    self.add(jax.random.fold_in(kb, leaf), (e, b, leaf))

    def add(self, key, at=None):
        seed = _seed_of(key)
        assert self.keys.setdefault(seed, key) is key, "two keys share a seed"
        if at is not None:
            self.seeds[at] = seed
        return seed

    def seed_fn(self, e, b, leaf):
        return self.seeds[e, b, leaf]

    def index_draw(self, seed, d, k):
        return torch.from_numpy(np.array(
            jax.random.choice(self.keys[seed], d, shape=(k,), replace=False)))

    def sketch_draw(self, seed, rows, cols):
        return torch.from_numpy(np.array(
            jax.random.normal(self.keys[seed], (rows, cols), jnp.float32)))


def _reference_seed_fn(chan_key, n_events, n_buffers, n_leaves):
    """``comm_seed_fn`` replaying the reference's key chain."""
    return ReferenceDraws(chan_key, n_events, n_buffers, n_leaves).seed_fn


def _assert_levels_close(got_q, want_q):
    """The int8 payloads agree but for at most FLIP_BUDGET of the elements,
    each off by one level."""
    got_q, want_q = np.asarray(got_q, np.int32), np.asarray(want_q, np.int32)
    off = np.abs(got_q - want_q)
    assert off.max(initial=0) <= 1, off.max()
    assert (off > 0).sum() <= FLIP_BUDGET * off.size, (off > 0).sum()


# ------------------------------------------------------------------- hash
@pytest.mark.parametrize("shape", [(8, 12544), (3, 7), (5, 1), (1, 1001)])
@pytest.mark.parametrize("key_int", [0, 1, 7, 2**31 + 5])
def test_hash_uniform_is_bit_exact(key_int, shape):
    key = jax.random.key(key_int)
    want = np.asarray(j_hash_uniform(key, shape))
    got = _hash_uniform(_seed_of(key), shape).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 0x9E3779B9, 2**32 - 1])
def test_hash_uniform_raw_seed_is_bit_exact(seed):
    want = np.asarray(j_hash_uniform(jnp.array([seed, 0], jnp.uint32), (4, 999)))
    np.testing.assert_array_equal(_hash_uniform(seed, (4, 999)).numpy(), want)


# ------------------------------------------------------------------ codec
def _leaf(seed, shape=(N, 33, 7)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("scale", [None, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qsgd_encode_decode_match_reference(dtype, scale):
    x = _leaf(3)
    key = jax.random.key(11)
    jx = jnp.asarray(x).astype(dtype)
    tx = params_from_numpy(np.asarray(jx), "cpu")
    jp = JQSGD().encode(jx, key, scale=None if scale is None else jnp.float32(scale))
    tp = QSGD().encode(tx, _seed_of(key), scale=scale)
    assert sorted(tp.data) == sorted(jp.data)
    np.testing.assert_array_equal(tp.data["scale"].numpy(), np.asarray(jp.data["scale"]))
    assert tp.data["q"].dtype == torch.int8
    _assert_levels_close(tp.data["q"].numpy(), jp.data["q"])
    if scale is not None:
        np.testing.assert_array_equal(tp.data["lv"].numpy(), np.asarray(jp.data["lv"]))
    got = QSGD().decode(tp)
    want = JQSGD().decode(jp)
    assert got.shape == want.shape and str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(tree_to_numpy(got), np.asarray(want.astype(jnp.float32)),
                               rtol=1e-6, atol=1e-7)


def test_qsgd_roundtrip_error_bound_and_unbiasedness():
    c = QSGD()
    x = torch.from_numpy(_leaf(1))
    dec = c.decode(c.encode(x, 0))
    step = x.reshape(N, -1).abs().amax(dim=1) / c.levels
    err = (dec - x).reshape(N, -1).abs().amax(dim=1)
    assert bool(torch.all(err <= step * (1 + 1e-5)))
    one = float((dec - x).abs().mean())
    avg = torch.stack([c.decode(c.encode(x, i)) for i in range(32)]).mean(dim=0)
    assert float((avg - x).abs().mean()) < one / 3


def test_identity_roundtrip_exact():
    x = torch.from_numpy(_leaf(0))
    c = Identity()
    assert torch.equal(c.decode(c.encode(x, 0)), x)


def test_error_feedback_residual_matches_reference():
    tree = {"w": _leaf(7), "b": _leaf(8, (N, 5))}
    res = {"w": 0.01 * _leaf(9), "b": 0.01 * _leaf(10, (N, 5))}
    key = jax.random.key(8)
    jc, tc = j_make_compressor("qsgd"), make_compressor("qsgd")
    jpay, jdec, jres = jc.roundtrip(jax.tree.map(jnp.asarray, tree),
                                    jax.tree.map(jnp.asarray, res), key)
    tpay, tdec, tres = tc.roundtrip(params_from_numpy(tree, "cpu"), params_from_numpy(res, "cpu"),
                                    lambda i: _seed_of(jax.random.fold_in(key, i)))
    for k in tree:
        _assert_levels_close(tpay[k].data["q"].numpy(), jpay[k].data["q"])
        np.testing.assert_allclose(tdec[k].numpy(), np.asarray(jdec[k]), **STATE_TOL)
        np.testing.assert_allclose(tres[k].numpy(), np.asarray(jres[k]), **STATE_TOL)
        # e' = (x + e) - D(C(x + e))
        np.testing.assert_allclose(tres[k].numpy(), tree[k] + res[k] - tdec[k].numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_payload_bytes_model():
    d = 100_000
    assert Identity().payload_bytes((d,), torch.float32) == d * 4
    q = QSGD().payload_bytes((d,), torch.float32)
    assert q == JQSGD().payload_bytes((d,), jnp.float32) == d + 4
    assert QSGD().payload_bytes((d,), torch.float32, scale=0.25) == \
        JQSGD().payload_bytes((d,), jnp.float32, scale=0.25)
    assert make_compressor("qsgd").payload_bytes((d,), torch.float32) == q
    # the sparsifiers: k values of the leaf's dtype + k int32 indices
    assert TopK(0.1).payload_bytes((d,), torch.float32) == 10_000 * 8
    assert RandK(0.25).payload_bytes((d,), torch.bfloat16) == 25_000 * 6
    for shape in ((196, 64), (64, 10), (64,), (10,), (3, 1), (7, 5, 3), (1,)):
        for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            for port, ref in ((TopK(0.1), JTopK(0.1)), (RandK(0.25), JRandK(0.25)),
                              (LowRank(2), JLowRank(2)), (LowRank(4), JLowRank(4))):
                for scale in (None, 0.3):
                    assert port.payload_bytes(shape, dt, scale=scale) == \
                        ref.payload_bytes(shape, jdt, scale=scale), (port, shape, dt, scale)
    # on the MLP, W1 and W2 factorize at r = 2; the biases go raw
    assert LowRank(2).payload_bytes((196, 64), torch.float32) == (196 + 64) * 2 * 4
    assert LowRank(2).payload_bytes((64,), torch.float32) == 64 * 4


def _tied_leaf(seed, shape=(N, 196, 64)):
    """Normal values on a coarse grid: many exact |x| ties, of both signs,
    and zeros -- where the tie-breaking rule decides the selection."""
    x = np.round(_leaf(seed, shape) * 4) / 4
    x[:, :3] = 0.0
    return x.astype(np.float32)


def _assert_packed_equal(tp, jp):
    assert sorted(tp.data) == sorted(jp.data)
    for k, t in tp.data.items():
        np.testing.assert_array_equal(tree_to_numpy(t), np.asarray(jp.data[k]).astype(
            np.float32 if t.dtype == torch.bfloat16 else np.asarray(jp.data[k]).dtype), err_msg=k)


@pytest.mark.parametrize("scale", [None, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(N, 196, 64), (N, 33, 7), (N, 10)])
def test_top_k_encode_decode_match_reference(shape, dtype, scale):
    """Indices equal in order (a stable descending-|x| sort, ties to the
    lower index), values bit for bit, on a leaf full of ties and zeros."""
    jx = jnp.asarray(_tied_leaf(4, shape)).astype(dtype)
    tx = params_from_numpy(np.asarray(jx), "cpu")
    key = jax.random.key(2)
    jp = JTopK(0.1).encode(jx, key, scale=None if scale is None else jnp.float32(scale))
    tp = TopK(0.1).encode(tx, _seed_of(key), scale=scale)
    assert tp.data["idx"].dtype == torch.int32 and tp.data["vals"].dtype == tx.dtype
    _assert_packed_equal(tp, jp)
    got, want = TopK(0.1).decode(tp), JTopK(0.1).decode(jp)
    assert got.shape == want.shape and got.dtype == tx.dtype
    np.testing.assert_array_equal(tree_to_numpy(got), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rand_k_matches_reference_with_its_draw(dtype):
    """RandK with the reference's ``jax.random.choice`` draw injected: one
    index set shared by every node, values bit for bit."""
    jx = jnp.asarray(_leaf(5, (N, 64, 10))).astype(dtype)
    tx = params_from_numpy(np.asarray(jx), "cpu")
    draws = ReferenceDraws(jax.random.key(9), 1, 1, 1)
    key = draws.keys[draws.seed_fn(0, 0, 0)]
    jp = JRandK(0.25).encode(jx, key)
    tp = RandK(0.25, index_draw=draws.index_draw).encode(tx, draws.seed_fn(0, 0, 0))
    _assert_packed_equal(tp, jp)
    assert bool((tp.data["idx"] == tp.data["idx"][:1]).all())
    np.testing.assert_array_equal(tree_to_numpy(RandK(0.25).decode(tp)),
                                  np.asarray(JRandK(0.25).decode(jp).astype(jnp.float32)))


def test_rand_k_default_draw_is_seeded_and_distinct():
    x = torch.from_numpy(_leaf(6, (N, 640)))
    a, b = RandK(0.25).encode(x, 17), RandK(0.25).encode(x, 17)
    assert torch.equal(a.data["idx"], b.data["idx"])
    assert not torch.equal(a.data["idx"], RandK(0.25).encode(x, 18).data["idx"])
    row = a.data["idx"][0]
    assert row.shape == (160,) and len(set(row.tolist())) == 160


@pytest.mark.parametrize("shape", [(N, 196, 64), (N, 64, 10), (N, 64), (N, 5, 3, 4)])
def test_low_rank_decodes_like_reference_with_its_sketch(shape):
    x = _leaf(7, shape)
    draws = ReferenceDraws(jax.random.key(4), 1, 1, 1)
    seed = draws.seed_fn(0, 0, 0)
    jp = JLowRank(2).encode(jnp.asarray(x), draws.keys[seed])
    tp = LowRank(2, sketch_draw=draws.sketch_draw).encode(torch.from_numpy(x), seed)
    assert sorted(tp.data) == sorted(jp.data)
    got = LowRank(2).decode(tp)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(JLowRank(2).decode(jp)),
                               rtol=1e-5, atol=1e-6)
    if "raw" in tp.data:
        np.testing.assert_array_equal(got.numpy(), x)
    else:   # orthonormal P: the decode is the projection P Pᵀ M
        p = tp.data["p"]
        eye = torch.eye(p.shape[-1]).expand(p.shape[0], -1, -1)
        torch.testing.assert_close(p.transpose(1, 2) @ p, eye, rtol=0, atol=1e-5)


# --------------------------------------------------------------- registry
def test_make_compressor_registry_and_shorthands():
    assert set(COMPRESSORS) >= {"identity", "qsgd", "top_k", "rand_k", "low_rank"}
    assert isinstance(make_compressor("identity"), Identity)
    c = make_compressor("qsgd")
    assert isinstance(c, ErrorFeedback) and isinstance(c.inner, QSGD) and c.uses_residual
    assert c.tag == j_make_compressor("qsgd").tag == "ef_qsgd"
    assert isinstance(make_compressor("qsgd", error_feedback=False), QSGD)
    assert make_compressor("qsgd:63").inner.levels == 63
    inst = QSGD(levels=31)
    assert make_compressor(inst) is inst
    for spec, cls, field, value in (("top_k:0.05", TopK, "ratio", 0.05),
                                    ("rand_k:0.5", RandK, "ratio", 0.5),
                                    ("low_rank:3", LowRank, "rank", 3),
                                    ("top_k", TopK, "ratio", 0.1)):
        c = make_compressor(spec)
        assert isinstance(c, ErrorFeedback) and type(c.inner) is cls, spec
        assert getattr(c.inner, field) == value
        assert c.tag == j_make_compressor(spec).tag
        assert type(make_compressor(spec, error_feedback=False)) is cls


@pytest.mark.parametrize(
    "bad", ["nope", 123, "top_k:zzz", "qsgd:9000", "top_k:0.0", "top_k:1.5", "low_rank:0"],
)
def test_make_compressor_rejects_junk(bad):
    with pytest.raises(ValueError):
        j_make_compressor(bad)
    with pytest.raises(ValueError):
        make_compressor(bad)


def test_error_feedback_wrapping_rules():
    with pytest.raises(ValueError):
        ErrorFeedback(inner=None)
    with pytest.raises(ValueError):
        ErrorFeedback(inner=ErrorFeedback(inner=QSGD()))
    assert ErrorFeedback(inner=Identity()).is_identity


def test_commspec_validation_edge_cases():
    for spec in (CommSpec, JCommSpec):
        assert spec(cadence="every_tau").comm_events_per_round(1) == 1
        assert spec(cadence="every_step").comm_events_per_round(1) == 1
        assert spec(cadence="every_step").comm_events_per_round(4) == 4
        assert spec(cadence="every_tau").round_len(1) == 1
        for kw in (dict(cadence="sometimes"), dict(reset="hard"),
                   dict(compression="nope"), dict(compression=3.14)):
            with pytest.raises(ValueError):
                spec(**kw)
        with pytest.raises(ValueError):   # a per-buffer mapping naming no buffer
            spec(channel={"nope": "sync"})
        with pytest.raises(ValueError):
            spec(channel="sync:3")
        assert spec().active_compression() is None
        assert spec(compression="identity").active_compression() is None
        assert spec(compression="identity").resolved_channel() is None
        assert spec(channel="sync").resolved_channel() is None
    spec = CommSpec(compression="qsgd")
    assert isinstance(spec.compression, ErrorFeedback)
    assert spec.active_compression() is spec.compression
    assert isinstance(spec.resolved_channel(), SyncChannel)
    assert spec.resolved_channel().tag == JCommSpec(compression="qsgd").resolved_channel().tag


def test_algorithm_compression_field_rebuilds_spec():
    alg = t_registry_make("dse_mvr", lr=0.1, tau=2, compression="qsgd")
    assert alg.comm.active_compression() is not None
    assert alg.comm.buffers == type(alg).comm.buffers
    assert type(alg).comm.compression is None
    assert t_registry_make("dse_mvr", lr=0.1, tau=2).comm.active_compression() is None


def test_channel_session_enforces_buffer_count():
    """The reference's buffer-count errors, with the port's seeds."""
    tree = {"w": torch.from_numpy(_leaf(10))}
    jtree = {"w": jnp.asarray(_leaf(10))}
    for lib, chan_cls, state_cls, session_cls, transport, t, state_of in (
        ("port", SyncChannel, ChannelState, ChannelSession, Transport(lambda x: x), tree,
         lambda wire: ChannelState(wire=wire)),
        ("reference", JSyncChannel, JChannelState, JChannelSession, JTransport(lambda x: x),
         jtree, lambda wire: JChannelState(wire=wire, key=jax.random.key(0))),
    ):
        channel = chan_cls(compression=(make_compressor if lib == "port"
                                        else j_make_compressor)("qsgd"))
        wire = channel.init_wire(t)
        extra = (lambda e, b, leaf: 0,) if lib == "port" else ()
        sess = session_cls(channel, 2, state_of((wire, wire)), transport, *extra)
        sess.mix(t)
        with pytest.raises(ValueError):
            sess.final_state()          # only 1 of 2 declared buffers gossiped
        sess.mix(t)
        assert len(sess.final_state().wire) == 2
        sess2 = session_cls(channel, 1, state_of((wire,)), transport, *extra)
        sess2.mix(t)
        with pytest.raises(ValueError):
            sess2.mix(t)                # more gossip calls than declared buffers


def test_attach_channel_state_and_compression_error():
    params = {"w": torch.zeros(N, 3), "b": torch.zeros(N)}
    plain = t_registry_make("dsgd", lr=0.1)
    state = plain.init(params)
    assert attach_channel_state(plain, state) is state
    assert bool(torch.isnan(compression_error(state)))
    alg = t_registry_make("gt_hsgd", lr=0.1, compression="qsgd")
    state = attach_channel_state(alg, alg.init(params))
    assert state.comp.event == 0 and len(state.comp.wire) == 2
    assert float(compression_error(state)) == 0.0
    state.comp.wire[1]["res"]["w"][0, 0] = 2.0
    assert float(compression_error(state)) == 4.0


# --------------------------------------------------- one compressed round
W = ring(N).w.astype(np.float64)
SHAPES = {"b": (N, 5), "w": (N, 6, 5)}


def _np_mix(tree):
    """A dense mix both sides compute identically: float64 numpy, to fp32."""
    return {k: (W @ np.asarray(x, np.float64).reshape(N, -1)).astype(np.float32)
            .reshape(x.shape) for k, x in tree.items()}


def _np_tree(rng, scale=1.0):
    return {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}


def _reference_like(cls_name, fields, **more):
    """An object named and shaped like a reference state, numpy leaves."""
    return type(cls_name, (), dict(fields, **more))()


def _comm_case(name, seed=0):
    """(numpy state fields, minibatch constant, full-gradient constant)."""
    rng = np.random.default_rng(seed)
    if name == "dse_mvr":
        st = dict(params=_np_tree(rng), x_ref=_np_tree(rng), v=_np_tree(rng, 0.5),
                  y=_np_tree(rng, 0.1), h_prev=_np_tree(rng, 0.1), z=None)
    else:
        st = dict(params=_np_tree(rng), v=_np_tree(rng, 0.5), y=_np_tree(rng, 0.5))
    res = (_np_tree(rng, 0.01), _np_tree(rng, 0.01))
    return st, res, _np_tree(rng), _np_tree(rng)


@pytest.mark.parametrize("use_fused", [False, True])
@pytest.mark.parametrize("name", ["dse_mvr", "gt_hsgd"])
def test_one_compressed_round_matches_reference(name, use_fused):
    """One QSGD-compressed communication event through both executors from
    the same state, wire residuals and seeds: params, tracking buffers and
    the new residuals agree."""
    st, res, mb, full = _comm_case(name)
    step, key = 3, jax.random.key(21)
    kw = dict(lr=0.1, alpha=0.2, beta=0.3, tau=1, compression="qsgd")
    jalg = j_registry_make(name, **kw)
    talg = t_registry_make(name, use_fused=use_fused, **kw)

    jwire = tuple({"res": jax.tree.map(jnp.asarray, r)} for r in res)
    jstate = type(jalg.init({k: jnp.zeros(s) for k, s in SHAPES.items()}))(
        **{k: None if v is None else jax.tree.map(jnp.asarray, v) for k, v in st.items()},
        step=jnp.int32(step), comp=JChannelState(wire=jwire, key=key))
    np_state = _reference_like(type(jstate).__name__, st, step=np.int32(step),
                               comp=JChannelState(wire=tuple({"res": r} for r in res), key=key))
    tstate = state_from_numpy(np_state, "cpu")

    jmix = lambda t: jax.tree.map(jnp.asarray, _np_mix(jax.tree.map(np.asarray, t)))  # noqa: E731
    tmix = lambda t: params_from_numpy(_np_mix(tree_to_numpy(t)), "cpu")  # noqa: E731
    jstep, _ = j_make_round_step(
        jalg, jmix, lambda p, c: jax.tree.map(lambda x, ci: x * 0.5 + ci, p, c),
        full_grad_fn=lambda p: jax.tree.map(lambda x, ci: x * 0.25 - ci, p,
                                            jax.tree.map(jnp.asarray, full)))
    tstep, _ = make_round_step(
        talg, tmix, lambda p, c: {k: p[k] * 0.5 + c[k] for k in p},
        full_grad_fn=lambda p: {k: p[k] * 0.25 - torch.from_numpy(full[k]) for k in p},
        comm_seed_fn=_reference_seed_fn(key, 1, 2, len(SHAPES)),
    )
    want = jstep(jstate, jax.tree.map(lambda c: jnp.asarray(c)[None], mb))
    tapi.reset_counters()
    got = tstep(tstate, [params_from_numpy(mb, "cpu")])
    # one quantize and one dequantize per leaf per buffer, one dispatch each
    assert tapi.call_counts()["qsgd_quantize"] == tapi.call_counts()["qsgd_dequantize"] == 4
    assert got.step == int(want.step) and got.comp.event == 1
    for field in [f for f in ("params", "x_ref", "v", "y", "h_prev") if f in st]:
        for k, w in getattr(want, field).items():
            np.testing.assert_allclose(tree_to_numpy(getattr(got, field))[k], np.asarray(w),
                                       **STATE_TOL, err_msg=f"{field}.{k}")
    for b in range(2):
        for k, w in want.comp.wire[b]["res"].items():
            np.testing.assert_allclose(tree_to_numpy(got.comp.wire[b]["res"])[k], np.asarray(w),
                                       **STATE_TOL, err_msg=f"res{b}.{k}")


def test_one_simulator_round_flips_few_levels(monkeypatch):
    """One compressed DSE-MVR round of both Simulators on the paper problem,
    from the same indices, initial parameters and seeds: the int8 payloads
    of its 8 messages (2 buffers x 4 leaves, 2 x 106,064 levels) agree but
    for a few levels, each off by one.  The inputs to the quantizer differ
    by the ulps of XLA's and ATen's GEMMs, and a level flips where such an
    ulp moves ``|x|·L + u`` across an integer."""
    from repro.compression import compressors as jcompressors
    from repro.core import Simulator as JSimulator
    from repro.core import ring as jring
    from repro_torch.compression import compressors as tcompressors

    payloads = {"ref": [], "port": []}

    def recording(cls, side):
        encode = cls.encode

        def wrapper(self, x, key, scale=None):
            packed = encode(self, x, key, scale=scale)
            payloads[side].append(np.asarray(packed.data["q"]))
            return packed

        monkeypatch.setattr(cls, "encode", wrapper)

    recording(jcompressors.QSGD, "ref")
    recording(tcompressors.QSGD, "port")
    key = jax.random.key(SEED + 1)
    data, _ = jcommon.make_paper_problem(OMEGA, seed=SEED)
    sim = JSimulator(jcommon.make_algorithm("dse_mvr", 0.3, TAU, 200, compression="qsgd"),
                     jring(N), jcommon.mlp_loss, data, batch_size=B)
    state = sim.init_state(jcommon.mlp_init(jax.random.key(SEED)), key)
    per_step, k = [], key
    for _ in range(TAU):   # the split order of Simulator._run_rounds
        k, sk = jax.random.split(k)
        per_step.append(data.sample(sk, B))
    sim._round_step(state, jax.tree.map(lambda *xs: jnp.stack(xs), *per_step))

    tdata, _ = tproblem.make_paper_problem(OMEGA, seed=SEED)
    idx = _reference_indices(key, TAU, N, B, tdata.samples_per_node)
    tsim = Simulator(tproblem.make_algorithm("dse_mvr", 0.3, TAU, 200, compression="qsgd"),
                     ring(N), tproblem.mlp_loss, tdata, B, device="cpu",
                     index_fn=lambda s: idx[s], comm_seed_fn=_reference_seed_fn(
                         jax.random.fold_in(key, CHANNEL_TAG), 1, 2, 4))
    tsim.run_rounds(tsim.init_state(_reference_init(SEED)), 1)

    assert len(payloads["port"]) == len(payloads["ref"]) == 8
    got = np.concatenate([q.reshape(-1) for q in payloads["port"]])
    want = np.concatenate([q.reshape(-1) for q in payloads["ref"]])
    assert got.size == 2 * 106_064
    _assert_levels_close(got, want)
    print(f"flipped levels in one round: {int((got != want).sum())} of {got.size}")


# ------------------------------------------------------- the whole problem
@pytest.mark.parametrize("name", sorted(ALGORITHMS))
def test_identity_is_the_uncompressed_path(name):
    """compression="identity" takes the exact uncompressed gossip path: the
    same tensors bit for bit, and no wire state."""
    outs = []
    for comp in (None, "identity"):
        alg = tproblem.make_algorithm(name, 0.3, TAU, 8, compression=comp, use_fused=True)
        data, _ = tproblem.make_paper_problem(OMEGA, seed=SEED)
        sim = Simulator(alg, ring(N), tproblem.mlp_loss, data, B, device="cpu", seed=3)
        outs.append(sim.run(tproblem.mlp_init(0), 8)["state"])
    assert outs[0].comp is None and outs[1].comp is None
    for k, leaf in outs[0].params.items():
        assert torch.equal(leaf, outs[1].params[k]), k


@pytest.mark.parametrize("use_fused", [False, True])
def test_run_method_qsgd_matches_reference(use_fused):
    """DSE-MVR with QSGD under error feedback, 64 steps, against the
    reference from the same indices, initial parameters and codec seeds.

    Measured gap (this test's printout, on a CPU): 1.0e-3
    relative on ``train_loss``, 5.6e-5 (plain) and 5.9e-4 (fused) on
    ``consensus``, one test point of 1000.  The uncompressed run stays
    within 2e-5 over 200 steps (``test_torch_simulator.py``); the compressed
    one drifts further because the quantizer is discontinuous: where the
    fp32 reassociation between XLA and ATen moves ``|x|·L + u`` across an
    integer, one int8 level flips (3 of the 212,128 levels of one round in
    ``test_one_simulator_round_flips_few_levels``), error feedback carries
    the difference, and later steps compound it.  The bound is set from
    that: rtol 5e-3 / atol 1e-5 on ``train_loss`` and ``consensus`` and
    5/1000 on ``test_acc``.
    """
    steps = 64
    want = jcommon.run_method("dse_mvr", OMEGA, TAU, B, steps, seed=SEED, compression="qsgd")
    data, _ = tproblem.make_paper_problem(OMEGA, seed=SEED)
    idx = _reference_indices(jax.random.key(SEED + 1), steps, N, B, data.samples_per_node)
    got = tproblem.run_method(
        "dse_mvr", OMEGA, TAU, B, steps, seed=SEED, compression="qsgd", device="cpu",
        use_fused=use_fused, index_fn=lambda s: idx[s], init_params=_reference_init(SEED),
        comm_seed_fn=_reference_seed_fn(
            jax.random.fold_in(jax.random.key(SEED + 1), CHANNEL_TAG), steps // TAU, 2, 4),
    )
    print("relative gap:", {k: abs(got[k] - want[k]) / abs(want[k])
                            for k in ("train_loss", "consensus", "test_acc")})
    for k in ("train_loss", "consensus"):
        np.testing.assert_allclose(got[k], want[k], rtol=5e-3, atol=1e-5, err_msg=k)
    assert abs(got["test_acc"] - want["test_acc"]) <= 5e-3


def test_compressed_comm_event_dispatch_counts():
    """A compressed DSE-MVR comm event on the fp32 MLP tree runs 8
    quantizes and 8 dequantizes (4 leaves x 2 buffers), whatever
    ``use_fused`` says."""
    data, _ = tproblem.make_paper_problem(OMEGA, seed=SEED)
    for use_fused in (False, True):
        alg = tproblem.make_algorithm("dse_mvr", 0.3, TAU, 8, compression="qsgd",
                                      use_fused=use_fused)
        sim = Simulator(alg, ring(N), tproblem.mlp_loss, data, B, device="cpu")
        state = sim.init_state(tproblem.mlp_init(0))
        tapi.reset_counters()
        state = sim.run_rounds(state, 1)
        counts = tapi.call_counts()
        assert counts["qsgd_quantize"] == counts["qsgd_dequantize"] == 8
        assert state.comp.event == 1 and tapi.launch_counts() == {}


def _link_bytes_both(name, **kw):
    params = _reference_init(SEED)
    jparams = jax.tree.map(jnp.asarray, tree_to_numpy(params))
    stacked = {k: v.unsqueeze(0).repeat((N,) + (1,) * v.dim()) for k, v in params.items()}
    jstacked = jax.tree.map(lambda p: jnp.broadcast_to(p[None], (N,) + p.shape), jparams)
    t = t_registry_make(name, lr=0.1, tau=4, **kw)
    j = j_registry_make(name, lr=0.1, tau=4, **kw)
    return link_bytes_per_round(t.comm, stacked), j_link_bytes(j.comm, jstacked)


@pytest.mark.parametrize("compression", [None, "identity", "qsgd", "qsgd:15"])
@pytest.mark.parametrize("name", ["dse_mvr", "gt_hsgd", "dlsgd"])
def test_link_bytes_per_round_matches_reference(name, compression):
    got, want = _link_bytes_both(name, compression=compression)
    assert got == want


@pytest.mark.parametrize("channel", [None, "choco", "async:2", {"params": "choco"}])
@pytest.mark.parametrize("compression", [None, "top_k:0.1", "rand_k:0.25", "low_rank:2"])
@pytest.mark.parametrize("name", ["dse_mvr", "gt_hsgd"])
def test_link_bytes_per_round_per_channel_matches_reference(name, compression, channel):
    """Each buffer counted through its own channel (``for_buffer``)."""
    got, want = _link_bytes_both(name, compression=compression, channel=channel)
    assert got == want


def test_state_from_numpy_carries_the_wire_state():
    st, res, _, _ = _comm_case("gt_hsgd")
    obj = _reference_like("GTHSGDState", st, step=np.int32(5),
                          comp=JChannelState(wire=({"res": res[0]}, None), key=None))
    got = state_from_numpy(obj, "cpu")
    assert type(got).__name__ == "GTHSGDState" and got.step == 5
    assert got.comp.event == 0 and got.comp.wire[1] is None
    np.testing.assert_array_equal(tree_to_numpy(got.comp.wire[0]["res"])["w"], res[0]["w"])
    assert dataclasses.is_dataclass(got)

    # an async overlap wire (hat, age, sent, fly with a packed top-k payload)
    # beside a choco wire, as the reference's state holds them
    rng = np.random.default_rng(3)
    hat = _np_tree(rng)
    payload = jax.tree.map(np.asarray, JTopK(0.2).encode_tree(
        jax.tree.map(jnp.asarray, _np_tree(rng)), jax.random.key(0)))
    age, sent = np.array([0, 3, 1, 2, 0, 1, 3, 2], np.int32), np.arange(N) % 3 == 0
    wire = ({"hat": hat, "age": age, "sent": sent, "fly": {"payload": payload, "sent": ~sent}},
            {"hat": hat})
    got = state_from_numpy(_reference_like("GTHSGDState", st, step=np.int32(1),
                                           comp=JChannelState(wire=wire, key=None)), "cpu")
    w0, w1 = got.comp.wire
    assert w0["age"].dtype == torch.int32 and w0["sent"].dtype == torch.bool
    np.testing.assert_array_equal(w0["age"].numpy(), age)
    np.testing.assert_array_equal(w0["sent"].numpy(), sent)
    np.testing.assert_array_equal(w0["fly"]["sent"].numpy(), ~sent)
    for k in SHAPES:
        np.testing.assert_array_equal(w0["hat"][k].numpy(), hat[k])
        np.testing.assert_array_equal(w1["hat"][k].numpy(), hat[k])
        pk = w0["fly"]["payload"][k]
        assert isinstance(pk, Packed) and pk.meta[1] == torch.float32
        assert pk.meta == (payload[k].meta[0], torch.float32, payload[k].meta[2])
        assert pk.data["idx"].dtype == torch.int32
        np.testing.assert_array_equal(pk.data["idx"].numpy(), payload[k].data["idx"])
        np.testing.assert_array_equal(pk.data["vals"].numpy(), payload[k].data["vals"])
        np.testing.assert_array_equal(TopK(0.2).decode(pk).numpy(),
                                      np.asarray(JTopK(0.2).decode(payload[k])))
