"""The sharded engine's pieces against the reference, in one process: the
node mesh, the mixers, the three packed transports, the channels' wire
modes and their abstract layouts, and the codec's global row numbering.

Every reference function here runs without a multi-device mesh (the
compressed allgather's on a one-device mesh, ``make_test_mesh((1,),
("data",))``),
and the port's counterpart runs on a one-rank :class:`NodeMesh` on the CPU,
from the same numpy inputs (ring(8), the ``exponential`` schedule's
rotations, top-k and QSGD payloads encoded by the reference).  fp32 within
rtol 1e-6 / atol 1e-7; indices, ages and send masks exactly.  The
spawned gloo groups and the reference's ``make_train_job`` are in
``test_torch_sharded_group.py``.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compression import AsyncChannel as JAsyncChannel
from repro.compression import ChocoChannel as JChocoChannel
from repro.compression import Transport as JTransport
from repro.compression import make_compressor as j_make_compressor
from repro.compression.gossip import allgather_combine as j_allgather_combine
from repro.compression.gossip import neighbor_exchange as j_neighbor_exchange
from repro.compression.gossip import rotation_combine as j_rotation_combine
from repro.core import ring as j_ring
from repro.core.mixing import Rotation as JRotation
from repro.core.mixing import dense_mix as j_dense_mix
from repro.core.mixing import node_pin as j_node_pin
from repro.core.mixing import replicate_gather as j_replicate_gather
from repro.core.mixing import replicate_pin as j_replicate_pin
from repro.core.mixing import replicated_local as j_replicated_local
from repro.core.mixing import roll_mix as j_roll_mix
from repro.core.mixing import scheduled_rotation_mix as j_scheduled_rotation_mix
from repro.launch.mesh import make_test_mesh as j_make_test_mesh
from repro.scenarios.schedules import make_topology_schedule as j_make_topology_schedule
from repro_torch.compression import (
    AsyncChannel, ChocoChannel, Packed, SyncChannel, Transport, make_compressor,
)
from repro_torch.compression.gossip import allgather_combine, neighbor_exchange, rotation_combine
from repro_torch.convert import _packed_from_numpy, _wire_from_numpy
from repro_torch.core import ring
from repro_torch.core.mixing import (
    Rotation, dense_mix, make_mix_fn, node_pin, replicate_gather, replicate_pin,
    replicated_local, ring_mix, roll_mix, scheduled_dense_mix, scheduled_rotation_mix,
)
from repro_torch.launch.mesh import NodeMesh, make_test_mesh
from repro_torch.scenarios.schedules import make_topology_schedule

TOL = dict(rtol=1e-6, atol=1e-7)
N = 8
SHAPES = {"b": (N, 7), "w": (N, 12, 10)}
W = ring(N).w


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small ops: beside other test
    workers, a pool of one OpenMP thread per core oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed: int, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


def _pair(np_tree):
    """The same numpy tree as a jax and a torch tree."""
    return (jax.tree.map(jnp.asarray, np_tree),
            {k: torch.from_numpy(v.copy()) for k, v in np_tree.items()})


def _flat(obj):
    """Leaves of a port or reference structure as numpy arrays: dicts by
    sorted key (as ``jax.tree`` orders them), tuples in order, packed
    payloads' data."""
    if isinstance(obj, dict):
        return [x for k in sorted(obj) for x in _flat(obj[k])]
    if isinstance(obj, (tuple, list)):
        return [x for v in obj for x in _flat(v)]
    if hasattr(obj, "data") and hasattr(obj, "meta"):
        return _flat(obj.data)
    if isinstance(obj, torch.Tensor):
        return [obj.detach().numpy()]
    return [np.asarray(obj)]


def _assert_close(got, want):
    g, w = _flat(got), _flat(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
        if a.dtype.kind in "fc":
            np.testing.assert_allclose(a, b, **TOL)
        else:
            np.testing.assert_array_equal(a, b)


def _exponential_rotations():
    j = j_make_topology_schedule("exponential", N).rotations()
    t = make_topology_schedule("exponential", N).rotations()
    assert [(r.self_weight, r.shifts, r.weights) for r in t] == \
        [(r.self_weight, tuple(r.shifts), tuple(r.weights)) for r in j]
    return j, t


# ------------------------------------------------------------------ the mesh
def test_one_rank_mesh_roll_gather_and_counts():
    """On one rank ``roll`` is ``torch.roll(a, -s)`` of every tensor of a
    packed tree, ``all_gather`` and ``rows`` the identity; the node-link
    count is the rows delivered, the process count 0."""
    mesh = make_test_mesh(N, device="cpu")
    packed = Packed({"idx": torch.arange(N * 3, dtype=torch.int32).reshape(N, 3),
                     "vals": torch.randn(N, 3)}, meta=((3,), torch.float32, 3))
    tree = {"p": packed, "m": torch.arange(N) % 3 == 0}
    for s in (1, -1, 3, N):
        got = mesh.roll(tree, s)
        assert got["p"].meta == packed.meta
        for a, b in zip(_flat(got), _flat(tree)):
            np.testing.assert_array_equal(a, np.roll(b, -s, axis=0))
    assert mesh.all_gather(tree) is tree and mesh.rows(tree) is tree
    row = 3 * 4 + 3 * 4 + 1
    assert mesh.byte_counts()["roll"] == {"node_link": 3 * N * row, "process": 0}
    assert mesh.byte_counts()["all_gather"] == {"node_link": N * (N - 1) * row, "process": 0}
    # a tree handed over as gathered is not gathered again by the dense
    # contraction
    mesh.reset_bytes()
    x = {"w": torch.randn(N, 5)}
    dense_mix(W, mesh=mesh)(replicate_pin(mesh)(x))
    assert mesh.byte_counts()["all_gather"]["node_link"] == 0
    dense_mix(W, mesh=mesh)({"w": torch.randn(N, 5)})
    assert mesh.byte_counts()["all_gather"]["node_link"] == N * (N - 1) * 20


class _FakeGroup:
    """Stands in for a process group of ``world`` ranks where only the
    mesh's checks run."""

    def __init__(self, world, backend="gloo"):
        self.world, self.backend = world, backend


def _fake_dist(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "get_backend", lambda g: g.backend)
    monkeypatch.setattr(dist, "get_world_size", lambda g: g.world)
    monkeypatch.setattr(dist, "get_rank", lambda g: 0)


def test_mesh_checks_its_split_and_backend(monkeypatch):
    _fake_dist(monkeypatch)
    with pytest.raises(ValueError, match="do not split"):
        NodeMesh(7, group=_FakeGroup(2), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8 \\(b\\)"):
        NodeMesh(8, group=_FakeGroup(2, "nccl"), device="cpu")
    mesh = NodeMesh(8, group=_FakeGroup(4), device="cpu")
    assert (mesh.world, mesh.n_local, mesh.lo, mesh.hi) == (4, 2, 0, 2)
    assert mesh._runs(1, 3) == [(2, 1, 1, 0), (3, 0, 1, 1)]


# ----------------------------------------------------------------- the mixers
def test_rotation_roll_and_dense_mix_match_reference():
    j, t = _pair(_tree(0))
    jrot, trot = JRotation.from_topology(j_ring(N)), Rotation.from_topology(ring(N))
    want = jrot.apply(j)
    mesh = make_test_mesh(N, device="cpu")
    for got in (trot.apply(t), trot.apply(t, mesh), roll_mix(ring(N), mesh)(t),
                make_mix_fn(ring(N), "roll", mesh)(t)):
        _assert_close(got, want)
    _assert_close(roll_mix(ring(N))(t), j_roll_mix(j_ring(N))(j))
    _assert_close(dense_mix(W, mesh=mesh)(t), j_dense_mix(j_ring(N).w)(j))
    _assert_close(make_mix_fn(ring(N), "allgather", mesh)(t), j_dense_mix(j_ring(N).w)(j))
    # ring_mix receives from i - s (the reference's ppermute direction):
    # on the symmetric ring the same operator, summed in another order
    _assert_close(ring_mix(ring(N), mesh)(t), want)


def test_scheduled_rotation_mix_matches_reference():
    jrots, trots = _exponential_rotations()
    j, t = _pair(_tree(1))
    mesh = make_test_mesh(N, device="cpu")
    jmix, tmix = j_scheduled_rotation_mix(jrots), scheduled_rotation_mix(trots, mesh)
    for p in range(len(trots)):
        _assert_close(tmix(t, SimpleNamespace(pattern=p)),
                      jmix(j, SimpleNamespace(pattern=jnp.int32(p))))
    w = torch.from_numpy(W.astype(np.float32))
    _assert_close(scheduled_dense_mix(mesh)(t, SimpleNamespace(w=w)), j_dense_mix(W)(j))


# ------------------------------------------------------------- the transports
def _payloads(spec: str, seed: int):
    """A reference payload tree of ``spec``, its decoded tree, and both as
    the port's."""
    jcomp = j_make_compressor(spec)
    j, _ = _pair(_tree(seed))
    payload = jcomp.encode_tree(j, jax.random.key(seed))
    dec = jcomp.decode_tree(payload)
    tpayload = jax.tree.map(lambda p: _packed_from_numpy(
        jax.tree.map(np.asarray, p), "cpu"), payload,
        is_leaf=lambda x: type(x).__name__ == "Packed")
    tdec = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in dec.items()}
    return jcomp, make_compressor(spec), payload, dec, tpayload, tdec


@pytest.mark.parametrize("spec", ["top_k:0.25", "qsgd"])
def test_rotation_combine_matches_reference(spec):
    jcomp, tcomp, payload, dec, tpayload, tdec = _payloads(spec, 2)
    mesh = make_test_mesh(N, device="cpu")
    jstatic = j_rotation_combine(jcomp, (JRotation.from_topology(j_ring(N)),))
    for m in (None, mesh):
        tstatic = rotation_combine(tcomp, (Rotation.from_topology(ring(N)),), mesh=m)
        _assert_close(tstatic(tpayload, tdec, None), jstatic(payload, dec, None))
    jrots, trots = _exponential_rotations()
    jsched = j_rotation_combine(jcomp, jrots, scheduled=True)
    tsched = rotation_combine(tcomp, trots, scheduled=True, mesh=mesh)
    for p in range(len(trots)):
        _assert_close(tsched(tpayload, tdec, SimpleNamespace(pattern=p)),
                      jsched(payload, dec, SimpleNamespace(pattern=jnp.int32(p))))


def test_neighbor_exchange_matches_reference():
    _, _, payload, _, tpayload, _ = _payloads("top_k:0.25", 3)
    jrots, trots = _exponential_rotations()
    mesh = make_test_mesh(N, device="cpu")
    jex, tex = j_neighbor_exchange(jrots, scheduled=True), neighbor_exchange(trots, True, mesh)
    assert tex.shifts == tuple(jex.shifts)
    for s in tex.shifts:
        _assert_close(tex.roll(tpayload, s), jex.roll(payload, s))
    j_self, t_self = _pair(_tree(4))
    nbrs = [_pair(_tree(5 + k)) for k in range(len(tex.shifts))]
    for p in range(len(trots)):
        _assert_close(tex.contract(t_self, [t for _, t in nbrs], SimpleNamespace(pattern=p)),
                      jex.contract(j_self, [j for j, _ in nbrs],
                                   SimpleNamespace(pattern=jnp.int32(p))))


@pytest.mark.parametrize("spec", ["top_k:0.25", "qsgd"])
def test_allgather_combine_matches_reference(spec):
    jcomp, tcomp, payload, dec, tpayload, tdec = _payloads(spec, 6)
    jmesh = j_make_test_mesh((1,), ("data",))
    mesh = make_test_mesh(N, device="cpu")
    _assert_close(allgather_combine(tcomp, mesh, w=W)(tpayload, tdec, None),
                  j_allgather_combine(jcomp, jmesh, w=W)(payload, dec, None))
    w = np.asarray(make_topology_schedule("exponential", N).generate(
        1, np.random.default_rng(0))[0][0], np.float32)
    _assert_close(
        allgather_combine(tcomp, mesh, scheduled=True)(
            tpayload, tdec, SimpleNamespace(w=torch.from_numpy(w))),
        j_allgather_combine(jcomp, jmesh, scheduled=True)(
            payload, dec, SimpleNamespace(w=jnp.asarray(w))))
    assert mesh.byte_counts()["all_gather"]["node_link"] > 0


# ----------------------------------------------------- the channels' wire modes
def _transports(mode: str):
    """The reference's and the port's transports of a wire mode."""
    jrot, trot = JRotation.from_topology(j_ring(N)), Rotation.from_topology(ring(N))
    mesh = make_test_mesh(N, device="cpu")
    if mode == "neighbor":
        jex, tex = j_neighbor_exchange((jrot,)), neighbor_exchange((trot,), mesh=mesh)
        return (JTransport(jrot.apply, neighbor=jex),
                Transport(roll_mix(ring(N), mesh), neighbor=tex), tex.shifts)
    jmesh = j_make_test_mesh((1,), ("data",))
    return (JTransport(j_dense_mix(W), gather_payload=j_replicate_gather(jmesh, ("data",)),
                       pin_replicated=j_replicate_pin(jmesh),
                       run_local=j_replicated_local(jmesh), pin_node=j_node_pin(jmesh, ("data",))),
            Transport(dense_mix(W, mesh=mesh), gather_payload=replicate_gather(mesh),
                      pin_replicated=replicate_pin(mesh), run_local=replicated_local(mesh),
                      pin_node=node_pin(mesh)),
            ())


CHANNELS = {
    "choco": (JChocoChannel, ChocoChannel, {}),
    "async": (JAsyncChannel, AsyncChannel, dict(max_staleness=2, threshold=0.5)),
}
MODES = [
    ("choco", "neighbor", {}), ("async", "neighbor", {}),
    ("choco", "replicated", {}), ("async", "replicated", {}),
    ("choco", "neighbor", dict(overlap=True)), ("choco", "neighbor", dict(overlap=True,
                                                                         defer_roll=True)),
    ("async", "neighbor", dict(overlap=True)), ("async", "neighbor", dict(overlap=True,
                                                                         defer_roll=True)),
    ("choco", "replicated", dict(overlap=True)), ("async", "replicated", dict(overlap=True)),
]


def _channels(name, mode, extra, shifts):
    jcls, tcls, kw = CHANNELS[name]
    kw = dict(kw, **extra)
    kw.update(neighbor_shifts=shifts) if mode == "neighbor" else kw.update(replicated_wire=True)
    return (jcls(compression=j_make_compressor("top_k:0.25", error_feedback=False), **kw),
            tcls(compression=make_compressor("top_k:0.25", error_feedback=False), **kw))


@pytest.mark.parametrize("name,mode,extra", MODES,
                         ids=[f"{n}-{m}-{'-'.join(e) or 'sync'}" for n, m, e in MODES])
def test_channel_wire_mode_event_matches_reference(name, mode, extra):
    """Two reference events build a wire state (replicas, neighbour replicas,
    the in-flight payload, ages); it is carried to the port, and one more
    event from the same tree gives the same iterate and the same wire."""
    jtr, ttr, shifts = _transports(mode)
    jchan, tchan = _channels(name, mode, extra, shifts)
    j0, _ = _pair(_tree(10))
    wire = jchan.init_wire(j0)
    for e in range(2):
        j, _ = _pair(_tree(11 + e))
        _, wire = jchan.gossip(j, wire, jax.random.key(e), None, jtr)
    twire = _wire_from_numpy(jax.tree.map(np.asarray, wire), "cpu")
    j, t = _pair(_tree(13))
    jout, jwire = jchan.gossip(j, wire, jax.random.key(2), None, jtr)
    tout, twire_new = tchan.gossip(t, twire, lambda leaf: 0, ttr, None)
    _assert_close(tout, jout)
    _assert_close(twire_new, jwire)
    assert twire_new.keys() == jwire.keys()


@pytest.mark.parametrize("name,mode,extra", MODES,
                         ids=[f"{n}-{m}-{'-'.join(e) or 'sync'}" for n, m, e in MODES])
def test_abstract_wire_and_spec_match_reference(name, mode, extra):
    """The meta-device wire has the reference's shapes and dtypes, leaf for
    leaf; the spec says "replicated" exactly where the reference's says
    ``P()``."""
    from jax.sharding import PartitionSpec as P

    jchan, tchan = _channels(name, mode, extra, (1, N - 1) if mode == "neighbor" else ())
    j, t = _pair(_tree(14))
    sds = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), j)
    want = jax.tree.leaves(jchan.abstract_wire(sds))
    got = _flat_meta(tchan.abstract_wire(t))
    assert [(tuple(x.shape), str(x.dtype)) for x in want] == \
        [(tuple(x.shape), str(x.dtype).replace("torch.", "")) for x in got]
    assert all(x.device.type == "meta" for x in got)
    jspec = jax.tree.leaves(
        jchan.wire_spec({k: P("data") for k in SHAPES}, P("data"), sds),
        is_leaf=lambda x: isinstance(x, P))
    tspec = _flat_strings(tchan.wire_spec(t))
    assert ["replicated" if s == P() else "node" for s in jspec] == tspec


def _flat_meta(obj):
    if isinstance(obj, dict):
        return [x for k in sorted(obj) for x in _flat_meta(obj[k])]
    if isinstance(obj, tuple):
        return [x for v in obj for x in _flat_meta(v)]
    if isinstance(obj, Packed):
        return _flat_meta(obj.data)
    return [obj]


def _flat_strings(obj):
    if isinstance(obj, dict):
        return [x for k in sorted(obj) for x in _flat_strings(obj[k])]
    if isinstance(obj, tuple):
        return [x for v in obj for x in _flat_strings(v)]
    if isinstance(obj, Packed):
        return _flat_strings(obj.data)
    return [obj]


# ------------------------------------------------------- the codec's row offset
def test_qsgd_noise_numbers_rows_globally():
    """A rank whose codec is bound to its first node (``at_rows(lo)``)
    draws for nodes [lo, hi) the noise those rows draw in the full encode,
    which is the reference's hash over the global iota."""
    comp = make_compressor("qsgd", error_feedback=False)
    x = torch.from_numpy(_tree(15)["w"])
    full = comp.encode(x, 1234)
    for lo, hi in ((0, 4), (4, 8), (2, 4), (6, 8)):
        part = comp.at_rows(lo).encode(x[lo:hi], 1234)
        for k in ("q", "scale"):
            assert torch.equal(part.data[k], full.data[k][lo:hi]), (lo, k)
    # without the offset the second block draws the first block's noise
    other = comp.encode(x[4:8], 1234)
    assert not torch.equal(other.data["q"], full.data["q"][4:8])


def test_row_binding_reaches_the_codec_through_wrappers_and_channels():
    """``at_rows`` binds QSGD inside error feedback and inside a channel,
    and leaves codecs whose draws are per leaf, and row 0, as they are."""
    ef = make_compressor("qsgd")
    assert ef.at_rows(4).inner.row0 == 4 and ef.at_rows(0) is ef
    top = make_compressor("top_k:0.25")
    assert top.at_rows(4) is top
    chan = SyncChannel(compression=ef)
    assert chan.at_rows(4).compression.inner.row0 == 4 and chan.at_rows(0) is chan
    assert ChocoChannel().at_rows(4).compression is None


@pytest.mark.parametrize("chunk", [1, 37, 1 << 10])
def test_hash_noise_in_chunks_is_the_whole_hash(monkeypatch, chunk):
    """The noise hash runs a chunk of elements at a time (its int64
    buffers stay a chunk's size); any chunk, across row boundaries and
    from any first row, gives the one-pass hash's bits."""
    import repro_torch.compression.compressors as comp_mod

    want = {row0: comp_mod._hash_uniform(99, (5, 211), row0) for row0 in (0, 3)}
    monkeypatch.setattr(comp_mod, "_HASH_CHUNK", chunk)
    for row0, w in want.items():
        assert torch.equal(comp_mod._hash_uniform(99, (5, 211), row0), w), (chunk, row0)
    assert torch.equal(want[3][:2], want[0][3:5])


def test_channel_modes_build_and_keep_their_fields():
    """The wire modes the sharded engine sets are built (they were refused
    before the engine was ported) and keep their checks."""
    c = ChocoChannel(neighbor_shifts=(1, -1))
    assert c.neighbor_shifts == (1, -1) and c.tag == "choco"
    assert AsyncChannel(replicated_wire=True).replicated_wire
    assert dataclasses.replace(ChocoChannel(overlap=True), defer_roll=True).defer_roll
    with pytest.raises(ValueError, match="mutually exclusive"):
        ChocoChannel(neighbor_shifts=(1,), replicated_wire=True)
    with pytest.raises(ValueError, match="overlap"):
        ChocoChannel(defer_roll=True)


# ------------------------------------------------------------ the train job
def _lm_tiny():
    from repro_torch.models import ModelConfig

    return ModelConfig(name="lm-tiny", arch_type="dense", n_layers=1, d_model=32, n_heads=4,
                       n_kv_heads=2, d_ff=64, vocab_size=256, block_unit=("attn",),
                       tie_embeddings=True)


@pytest.mark.parametrize("kw", [{}, dict(channel="choco", compression="top_k:0.1"),
                                dict(channel="async:2", compression="top_k:0.1",
                                     overlap=True),
                                dict(channel="choco", compression="top_k:0.1",
                                     gossip="dense", wire_mode="allgather")],
                         ids=["plain", "neighbor", "async-overlap", "replicated"])
def test_train_job_abstract_state_and_layout(kw):
    """The meta-device abstract state has the real state's structure, shapes
    and dtypes, allocating nothing; the layout marks the compressed
    allgather's wire replicated, the step a host int, the rest node rows."""
    from repro_torch.launch.distributed import make_train_job, state_bytes
    from repro_torch.tree import map_tensors

    job = make_train_job(_lm_tiny(), make_test_mesh(4, device="cpu"), tau=3, lr=1e-2, **kw)
    state = job.init_state(0)

    def shapes(obj):
        out = []
        map_tensors(lambda t: out.append((tuple(t.shape), t.dtype, t.device.type)), obj)
        return out

    got, want = shapes(job.abstract_state), shapes(state)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    assert {g[2] for g in got} == {"meta"}
    assert state_bytes(job.abstract_state) == state_bytes(state)
    layout = job.state_layout
    assert layout.step == "host"
    assert set(_flat_strings(layout.params)) == {"node"}
    if "compression" in kw:
        wire = set(_flat_strings(layout.comp.wire))
        assert wire == ({"replicated"} if kw.get("wire_mode") == "allgather" else {"node"})
        assert layout.comp.event == "host"


def test_grad_accum_matches_one_microbatch():
    """``grad_accum=2`` sums the two microbatches' gradients in fp32 and
    halves them: the full batch's mean-loss gradient, up to rounding.  The
    activations are bf16 and a microbatch's forward rounds them otherwise,
    so the params after a round agree within atol 1e-5 / rtol 1e-3 (3.3e-6
    apart at most, measured on a CPU)."""
    from repro_torch.launch.distributed import make_train_job
    from repro_torch.tree import tree_leaves

    rng = np.random.default_rng(3)
    batches = {"tokens": rng.integers(0, 256, (3, 4, 2, 16)),
               "targets": rng.integers(0, 256, (3, 4, 2, 16))}
    out = {}
    for accum in (1, 2):
        job = make_train_job(_lm_tiny(), make_test_mesh(4, device="cpu"), tau=3, lr=1e-2,
                             grad_accum=accum)
        state, metrics = job.step_fn(job.init_state(0), job.local_batch(batches))
        out[accum] = (tree_leaves(state.params), metrics)
    for a, b in zip(out[1][0], out[2][0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-5)
    with pytest.raises(ValueError, match="microbatches"):
        job = make_train_job(_lm_tiny(), make_test_mesh(4, device="cpu"), tau=3, grad_accum=3)
        job.step_fn(job.init_state(0), job.local_batch(batches))


@pytest.mark.parametrize("profile", ["2d"])
def test_train_job_refuses_a_sharding_profile(profile):
    """What the '2d' layout once refused on a node spread over a model axis
    of 2 (ROADMAP queue 1 item 8 (b) 5) -- a codec, here QSGD -- now builds
    a job: each sharded leaf's codec bound to its model shard (the mesh here
    is a stand-in with a model axis of 2, whose building moves nothing; the
    spawned groups of ``test_torch_layout_group.py`` and
    ``test_torch_layout_2d_codecs.py`` train it on real ones).  On a model
    axis of 1 every profile is the replica job."""
    from repro_torch.compression.base import AtShard
    from repro_torch.launch.distributed import make_train_job

    group = SimpleNamespace(size=2, index=0)
    mesh = SimpleNamespace(n_nodes=2, model=2, data=1, data_axis=False, world=1, rank=0, lo=0,
                           hi=2, n_local=2, device=torch.device("cpu"), model_group=group,
                           data_group=None, node_group=group, axis_names=("data", "model"),
                           devices=np.zeros((1, 2)))
    job = make_train_job(_lm_tiny(), mesh, profile=profile, compression="qsgd")
    codec = job.algorithm.comm.resolved_channel().compression
    bound = [codec.for_leaf(i).inner for i in range(len(job.shard_dims))]
    assert job.profile.name == profile and any(d is not None for d in job.shard_dims)
    for b, d in zip(bound, job.shard_dims):
        assert isinstance(b, AtShard) == (d is not None)
        if d is not None:
            assert b.shard.group is group and b.shard.dim == d and b.node is group
    for name in ("tp", "fsdp", "2d"):
        job = make_train_job(_lm_tiny(), make_test_mesh(4, device="cpu"), profile=name)
        assert job.profile.name == name and set(job.shard_dims) == {None}


def test_ring_mix_is_the_flipped_rotation():
    """``ring_mix`` receives from i - s: on an asymmetric shift set it is
    the rotation with its shifts negated, bit for bit, and not the rotation
    itself."""
    from repro_torch.core.topology import Topology

    w = np.zeros((N, N))
    for i in range(N):
        w[i, i], w[i, (i + 1) % N], w[i, (i + 3) % N] = 0.5, 0.3, 0.2
    topo = Topology(name="skew", n=N, w=w,
                    neighbors=tuple(((i + 1) % N, (i + 3) % N) for i in range(N)), shifts=(1, 3))
    x = {"a": torch.from_numpy(np.random.default_rng(5).standard_normal((N, 6), np.float32))}
    got = ring_mix(topo)(x)["a"]
    want = 0.5 * x["a"] + 0.3 * torch.roll(x["a"], 1, 0) + 0.2 * torch.roll(x["a"], 3, 0)
    assert torch.equal(got, want)
    assert not torch.allclose(got, roll_mix(topo)(x)["a"])

