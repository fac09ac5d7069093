"""The port's serving plane (``repro_torch.serving``: snapshots, replica sets,
the remote feed) and its control-channel framing (``repro_torch.runtime``)
against the reference's, on the same numpy inputs, on the CPU.

Randomness is injected: the reference splits its snapshot key once per
publish and folds the leaf index into the first half; its QSGD noise hash
reads ``key_data[0] ^ key_data[-1]`` of that key.  ``_reference_seeds``
replays the chain and hands the port the resulting uint32 seeds through
``SnapshotPublisher(seed_fn=...)``.

Tolerances:
  * snapshots, ages, send masks, analytic and packed bytes: bit for bit
    (the codecs are bit for bit on equal inputs, and a publish is one fp32
    subtraction and one fp32 add a leaf);
  * the relative drift: rtol 1e-6 (the sums over a leaf reduce in another
    order);
  * a ``ReplicaSet`` fed by each package's Simulator from the same indices:
    the served identity snapshot within the one-round state band, rtol 1e-5
    / atol 1e-6, since the two trainers drift apart by fp32 ulps; ages,
    send masks and link bytes exactly.

Socket tests dial with ``connect_with_retry`` (a 10 s timeout on every
receive) and close both ends in ``finally``.
"""
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compression import make_compressor as j_make_compressor
from repro.core import Simulator as JSimulator
from repro.core import make_algorithm as j_make_algorithm
from repro.core import ring as jring
from repro.core.simulate import node_mean as j_node_mean
from repro.data import iid_partition as j_iid
from repro.data import make_classification as j_classification
from repro.data import partition_to_node_data as j_to_node_data
from repro.runtime import protocol as jprotocol
from repro.serving import ReplicaSet as JReplicaSet
from repro.serving import SnapshotPublisher as JPublisher
from repro_torch import runtime as truntime
from repro_torch.compression import ErrorFeedback, make_compressor
from repro_torch.core import Simulator, make_algorithm, ring
from repro_torch.core.simulate import node_mean
from repro_torch.data import iid_partition, make_classification, partition_to_node_data
from repro_torch.runtime import MessageSocket
from repro_torch.serving import (
    RemoteReplica, ReplicaSet, SnapshotFeed, SnapshotPublisher, SnapshotState,
)
from repro_torch.tree import tree_leaves
from test_torch_simulator import _reference_indices

N_NODES, DIM, CLASSES = 4, 8, 3
CODECS = (None, "identity", "qsgd", "top_k:0.25")


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
    d = np.asarray(jax.random.key_data(key)).astype(np.uint32).reshape(-1)
    return int(d[0] ^ d[-1])


def _reference_seeds(key, n_publishes, n_leaves):
    """``seed_fn(seq, leaf)`` replaying the reference publisher's keys."""
    seeds = {}
    for seq in range(n_publishes):
        use, key = jax.random.split(key)
        for leaf in range(n_leaves):
            seeds[seq, leaf] = _seed_of(jax.random.fold_in(use, leaf))
    return lambda seq, leaf: seeds[seq, leaf]


def _np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (scale * rng.standard_normal((6, 4))).astype(np.float32),
            "b": (scale * rng.standard_normal(4)).astype(np.float32)}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _pair(codec, bounds, threshold=None, key=7, n_publishes=8):
    """(reference publisher, its key, port publisher with the same seeds)."""
    jkey = jax.random.key(key)
    jpub = JPublisher(codec=codec, bounds=bounds, threshold=threshold)
    tpub = SnapshotPublisher(codec=codec, bounds=bounds, threshold=threshold,
                             seed_fn=_reference_seeds(jkey, n_publishes, 2))
    return jpub, jkey, tpub


def _assert_state_equal(t_state, j_state):
    for a, b in zip(tree_leaves(t_state.hat), jax.tree.leaves(j_state.hat)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(t_state.age.numpy(), np.asarray(j_state.age))
    np.testing.assert_array_equal(t_state.sent.numpy(), np.asarray(j_state.sent))
    assert t_state.seq == int(j_state.seq)


def _assert_states_identical(a: SnapshotState, b: SnapshotState):
    for x, y in zip(tree_leaves(a.hat), tree_leaves(b.hat)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert torch.equal(a.age, b.age) and torch.equal(a.sent, b.sent)
    assert (a.seq, a.key) == (b.seq, b.key)


# ------------------------------------------------------------- publisher
def test_publisher_validation_and_codec_binding():
    for kw in (dict(bounds=()), dict(bounds=(1, 0)), dict(threshold=-0.5),
               dict(codec="bogus_codec")):
        with pytest.raises(ValueError):
            JPublisher(**kw)
        with pytest.raises(ValueError):
            SnapshotPublisher(**kw)
    # the identity spec collapses to the raw path
    assert SnapshotPublisher().tag == JPublisher().tag == "raw"
    assert SnapshotPublisher(codec="identity").codec is None
    # error feedback is unwrapped: the replica estimate IS the memory
    for spec in ("qsgd", "top_k:0.25"):
        ef = make_compressor(spec, error_feedback=True)
        assert isinstance(ef, ErrorFeedback)
        pub = SnapshotPublisher(codec=ef)
        assert not isinstance(pub.codec, ErrorFeedback)
        assert pub.tag == ef.inner.tag == JPublisher(
            codec=j_make_compressor(spec, error_feedback=True)).tag


def test_first_publish_populates_every_replica():
    jpub, jkey, tpub = _pair(None, (1, 3, 5))
    live = _np_tree(0)
    t_state, j_state = tpub.init(_t(live)), jpub.init(_j(live), key=jkey)
    np.testing.assert_array_equal(t_state.age.numpy(), [0, 2, 4])
    _assert_state_equal(t_state, j_state)
    t_state, info = tpub.publish(t_state, _t(live))
    assert bool(info["sent"].all())
    for r in range(3):
        for k, v in tpub.replica_params(t_state, r).items():
            np.testing.assert_array_equal(v.numpy(), live[k])


@pytest.mark.parametrize("threshold", [None, 0.6])
@pytest.mark.parametrize("codec", CODECS)
def test_publish_sequence_matches_reference(codec, threshold):
    """Six publishes of drifting parameters through both publishers: the
    snapshots, ages, send masks, bytes and message sizes agree bit for bit;
    with a drift trigger, the drift within rtol 1e-6 and the refreshes it
    triggers exactly."""
    jpub, jkey, tpub = _pair(codec, (1, 2, 4), threshold)
    base = _np_tree(1)
    t_state, j_state = tpub.init(_t(base)), jpub.init(_j(base), key=jkey)
    assert tpub.message_bytes(_t(base)) == jpub.message_bytes(_j(base))
    triggered = 0
    for s in range(6):
        live = {k: v + 0.3 * (s + 1) * _np_tree(10 + s)[k] for k, v in base.items()}
        forced = np.asarray(j_state.age) + 1 >= np.asarray(jpub.bounds)
        j_state, j_info = jpub.publish(j_state, _j(live))
        t_state, t_info = tpub.publish(t_state, _t(live))
        _assert_state_equal(t_state, j_state)
        for k in ("sent", "age", "bytes"):
            np.testing.assert_array_equal(t_info[k].numpy(), np.asarray(j_info[k]), err_msg=k)
        drift = np.asarray(j_info["drift"])
        np.testing.assert_allclose(t_info["drift"].numpy(), drift, rtol=1e-6)
        if threshold is not None:
            # a case clear of ties: no drift within 1% of the trigger
            assert np.all(np.abs(drift - threshold) > 0.01 * threshold), drift
            triggered += int(np.sum(np.asarray(j_info["sent"]) & ~forced))
    if threshold is not None:
        assert triggered > 0, "the drift trigger never fired"


@pytest.mark.parametrize("codec", [None, "qsgd", "top_k:0.25"])
def test_publish_packed_replay(codec):
    """``publish`` is ``publish_packed`` minus the message, bit for bit; a
    subscriber replaying only the packed messages reaches the publisher's
    state; the packed sizes equal the reference's, and a lossy message is
    smaller than the raw tree."""
    jpub, jkey, tpub = _pair(codec, (1, 3))
    base = _np_tree(0)
    a = tpub.init(_t(base), key=9)
    b = tpub.init(_t(base), key=9)
    sub = tpub.init(_t(base), key=123)   # the messages carry the key
    j_state = jpub.init(_j(base), key=jkey)
    raw_bytes = sum(v.nbytes for v in base.values())
    for s in range(5):
        live = {k: v * (0.5 + s) for k, v in base.items()}
        a, a_info = tpub.publish(a, _t(live))
        b, b_info, packed = tpub.publish_packed(b, _t(live))
        sub = tpub.apply_packed(sub, packed)
        _assert_states_identical(a, b)
        _assert_states_identical(sub, b)
        for k in a_info:
            assert torch.equal(a_info[k], b_info[k]), k
        j_state, _, j_packed = jpub.publish_packed(j_state, _j(live))
        assert tpub.packed_bytes(packed) == jpub.packed_bytes(j_packed)
        if codec is not None:
            assert tpub.packed_bytes(packed) < tpub.n_replicas * raw_bytes
    with pytest.raises(ValueError, match="applied to a state"):
        tpub.apply_packed(sub, packed)   # a message out of sequence


@pytest.mark.parametrize("bounds", [(1,), (1, 2)])
def test_identity_snapshot_does_not_alias_live_params(bounds):
    """A trainer updates its parameters in place; a refreshed identity
    snapshot keeps the values of its publish."""
    pub = SnapshotPublisher(bounds=bounds)
    live = _t(_np_tree(2))
    want = {k: v.clone() for k, v in live.items()}
    state, _ = pub.publish(pub.init(live), live)
    for v in live.values():
        v.mul_(3.0).add_(1.0)
    for r in range(len(bounds)):
        for k, v in pub.replica_params(state, r).items():
            assert torch.equal(v, want[k])
            assert v.data_ptr() != live[k].data_ptr()


# --------------------------------------------------- ReplicaSet (simulator)
def _jax_loss(params, batch):
    xb, yb = batch
    logp = jax.nn.log_softmax(xb @ params["w"] + params["b"])
    return -jnp.take_along_axis(logp, yb[..., None], axis=-1).mean()


def _torch_loss(params, batch):
    xb, yb = batch   # (N, b, D), (N, b)
    logits = torch.einsum("nbd,ndc->nbc", xb, params["w"]) + params["b"][:, None, :]
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, yb[..., None].long())[..., 0].mean(dim=1)


def test_replicaset_simulator_roundtrip_matches_reference():
    """Both packages train DSE-MVR on a 4-node ring from the same indices
    and publish the node mean to identity, qsgd and top-k sets after every
    round: the identity bound-1 replica serves the live mean bit for bit,
    the lossy ones land within codec tolerance, the SLO holds, bound 2
    moves half of bound 1's bytes, and ages, sends and bytes equal the
    reference's."""
    rounds, tau, batch = 8, 2, 8
    x, y = make_classification(400, DIM, CLASSES, seed=0, class_sep=2.0)
    data = partition_to_node_data(x, y, iid_partition(len(x), N_NODES, seed=0))
    jx, jy = j_classification(400, DIM, CLASSES, seed=0, class_sep=2.0)
    jdata = j_to_node_data(jx, jy, j_iid(len(jx), N_NODES, seed=0))
    np.testing.assert_array_equal(data.x, jdata.x)
    hyper = dict(lr=0.15, tau=tau, alpha=0.2)
    jsim = JSimulator(j_make_algorithm("dse_mvr", **hyper), jring(N_NODES), _jax_loss, jdata,
                      batch_size=batch)
    idx = _reference_indices(jax.random.key(1), rounds * tau, N_NODES, batch,
                             data.samples_per_node)
    sim = Simulator(make_algorithm("dse_mvr", **hyper), ring(N_NODES), _torch_loss, data, batch,
                    device="cpu", index_fn=lambda s: idx[s])
    init = {"w": np.zeros((DIM, CLASSES), np.float32), "b": np.zeros(CLASSES, np.float32)}
    j_state, key = jsim.init_state(_j(init), jax.random.key(0)), jax.random.key(1)
    state = sim.init_state(_t(init))

    specs = ("identity", "qsgd", "top_k:0.25")
    jsets = {c: JReplicaSet(_j(init), codec=c, bounds=(1, 2)) for c in specs}
    sets = {c: ReplicaSet(_t(init), publisher=SnapshotPublisher(
        codec=c, bounds=(1, 2), seed_fn=_reference_seeds(jax.random.key(0), rounds, 2)))
        for c in specs}
    for _ in range(rounds):
        j_state, key = jsim.run_rounds(j_state, key, 1)
        state = sim.run_rounds(state, 1)
        j_live, live = j_node_mean(j_state.params), node_mean(state.params)
        for c in specs:
            j_info, t_info = jsets[c].publish(j_live), sets[c].publish(live)
            for k in ("sent", "age", "bytes"):
                np.testing.assert_array_equal(t_info[k], j_info[k], err_msg=f"{c} {k}")

    live, j_live = node_mean(state.params), j_node_mean(j_state.params)
    for k, v in live.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(j_live[k]), rtol=1e-5, atol=1e-6)
    for c, rs in sets.items():
        rs.assert_slo()
        served = rs.params_for(0)
        if c == "identity":
            for k, v in served.items():
                assert torch.equal(v, live[k])
        else:
            num = sum(float(torch.sum((served[k] - live[k]) ** 2)) for k in live)
            den = sum(float(torch.sum(live[k] ** 2)) for k in live)
            assert (num / den) ** 0.5 < 0.35, c
        kb = rs.link_bytes()
        assert kb[1] == pytest.approx(kb[0] / 2, rel=1e-6)
        np.testing.assert_array_equal(kb, jsets[c].link_bytes())
        assert rs.slo_report() == jsets[c].slo_report()
    raw_kb = sets["identity"].link_bytes()[0]
    assert sets["qsgd"].link_bytes()[0] < raw_kb
    assert sets["top_k:0.25"].link_bytes()[0] < raw_kb


# ----------------------------------------------------------------- remote
@pytest.mark.parametrize("codec,dtype", [("qsgd", torch.float32), (None, torch.bfloat16)])
def test_remote_replica_byte_equal_with_feed(codec, dtype):
    """A RemoteReplica pulling packed messages over a real localhost socket
    reconstructs the feed's snapshot state byte for byte, a drained pull
    moves no message, a bf16 identity leaf crosses intact, and the feed's
    log is not changed by in-place updates of the live parameters."""
    pub = SnapshotPublisher(bounds=(1, 3), codec=codec)
    params = {"w": torch.linspace(-1.0, 1.0, 24).reshape(4, 6).to(dtype),
              "b": torch.zeros(4, dtype=dtype)}
    feed = SnapshotFeed(pub, params, key=5)
    replica = RemoteReplica(feed.address, pub, params, key=5, device="cpu")
    try:
        assert replica.conn.sock.gettimeout() == 10.0
        live = {k: v.clone() for k, v in params.items()}
        for t in range(4):
            for v in live.values():
                v.add_(0.1 * (t + 1))
            feed.publish(live)
        want = {k: v.clone() for k, v in live.items()}
        for v in live.values():
            v.mul_(-7.0)   # after the publishes: no message may see this
        assert replica.pull() == 4
        rx = replica.link_bytes()["rx"]
        assert replica.pull() == 0
        assert replica.link_bytes()["rx"] - rx < 200   # an empty reply frame
        _assert_states_identical(replica.state, feed.state)
        for v in tree_leaves(replica.state.hat):
            assert v.dtype == dtype
        if codec is None:
            for k, v in replica.params_for(0).items():
                assert torch.equal(v, want[k])
        replica.conn.send({"type": "stat"})
        assert replica.conn.recv() == {"type": "stat", "seq": 4, "tag": pub.tag, "bounds": (1, 3)}
        # the feed's server thread counts a reply once ``sendall`` returns,
        # which may be after the replica has read it: wait for the count
        rx, deadline = replica.link_bytes()["rx"], time.monotonic() + 5.0
        while feed.link_bytes()["tx"] != rx and time.monotonic() < deadline:
            time.sleep(0.001)
        assert feed.link_bytes()["tx"] == rx
    finally:
        replica.close()
        feed.close()


def test_remote_qsgd_moves_fewer_bytes_than_raw():
    params = {"w": torch.linspace(-1.0, 1.0, 4096).reshape(64, 64), "b": torch.zeros(64)}
    tx = {}
    for codec in (None, "qsgd"):
        pub = SnapshotPublisher(bounds=(1,), codec=codec)
        feed = SnapshotFeed(pub, params)
        replica = RemoteReplica(feed.address, pub, params, device="cpu")
        try:
            for t in range(3):
                feed.publish({k: v + 0.01 * t for k, v in params.items()})
            assert replica.pull() == 3
            _assert_states_identical(replica.state, feed.state)
            # the feed's server thread counts a reply once ``sendall``
            # returns, which may be after the replica has read it: wait for
            # the count
            rx, deadline = replica.link_bytes()["rx"], time.monotonic() + 5.0
            while feed.link_bytes()["tx"] != rx and time.monotonic() < deadline:
                time.sleep(0.001)
            tx[codec] = feed.link_bytes()["tx"]
            assert tx[codec] == rx
        finally:
            replica.close()
            feed.close()
    assert tx["qsgd"] < 0.3 * tx[None], tx


def test_remote_replicas_pull_while_the_feed_publishes():
    """Stress: more pulling subscribers than cores, each on its own thread
    and socket, while the feed publishes; every replica ends byte-equal
    with the feed (a lost or reordered log entry would break it)."""
    import os
    import sys
    import threading

    pub = SnapshotPublisher(bounds=(1, 2), codec="qsgd")
    params = _t(_np_tree(4))
    feed = SnapshotFeed(pub, params, key=11)
    n_sub, n_pub = (os.cpu_count() or 1) + 2, 6
    replicas = [RemoteReplica(feed.address, pub, params, device="cpu") for _ in range(n_sub)]
    errors = []

    def follow(rep):
        try:
            while rep.applied < n_pub:
                rep.pull()
        except Exception as e:   # reported by the main thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=follow, args=(r,)) for r in replicas]
        for t in threads:
            t.start()
        for s in range(n_pub):
            feed.publish({k: v * (1.0 + 0.1 * s) for k, v in params.items()})
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads), "a subscriber did not finish"
        assert not errors, errors
        for rep in replicas:
            _assert_states_identical(rep.state, feed.state)
    finally:
        sys.setswitchinterval(interval)
        for rep in replicas:
            rep.close()
        feed.close()


# ---------------------------------------------------------------- runtime
def test_message_protocol_roundtrip_and_framing():
    """The port's framing round-trips and counts the reference's bytes."""
    payload = {"type": "contrib", "rows": np.arange(12).reshape(3, 4),
               "nested": {"x": [1, 2, 3]}}
    a, b = socket.socketpair()
    ca, cb = MessageSocket(a), MessageSocket(b)
    ca.send(payload)
    got = cb.recv()
    assert got["type"] == "contrib"
    np.testing.assert_array_equal(got["rows"], payload["rows"])
    assert ca.tx_bytes == cb.rx_bytes
    ca.close()
    assert cb.recv() is None      # clean EOF
    cb.close()
    # the same frame on the wire as the reference's
    a, b = socket.socketpair()
    try:
        assert truntime.send_msg(a, payload) == jprotocol.send_msg(a, payload)
        for recv in (jprotocol.recv_msg_sized, truntime.recv_msg_sized):
            msg, n = recv(b)
            assert n == ca.tx_bytes and msg["nested"] == payload["nested"]
    finally:
        a.close()
        b.close()
    assert truntime.MAX_MESSAGE_BYTES == jprotocol.MAX_MESSAGE_BYTES
    assert truntime.attach_trace({}, "t")[truntime.TRACE_FIELD] == "t"
    from repro_torch.runtime.launch import launch

    assert truntime.launch is launch      # the elastic runtime is ported
