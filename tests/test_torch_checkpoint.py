"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``): one on-disk format, read both ways.

  * the port's MessagePack manifests: the bytes ``msgpack.packb`` gives, and
    read back as ``msgpack.unpackb`` reads them;
  * a reference checkpoint of a CHOCO top-k DSE-MVR state after 3 rounds,
    loaded by the port (``state_from_checkpoint``) and continued 3 rounds
    from the reference's indices, against the reference's continuation:
    rtol 1e-5 / atol 1e-6 per round on every buffer and on the wire (the
    one-round band of ``test_torch_simulator``), the step exactly;
  * parameter trees (fp32 and bf16) written by one package and read by the
    other with ``like=``: equal bits.  The reference reads a bf16 leaf back
    as a 2-byte void array (ROADMAP queue 3, caveats in the reference), so
    its bits are compared through a uint16 view; the port reads it as
    ``torch.bfloat16``;
  * the port's own state round trip with ``like=``, wire, in-flight payload,
    step and event included: bit for bit;
  * a port CHOCO top-k state after 2 rounds, loaded by the reference with
    ``like=`` its own state (the event sits at the key's position as uint32
    key data) and run on one round from the reference's indices, against
    the port's own next round from the same indices: the one-round band;
    a port QSGD state read by the reference, leaf for leaf; and an older
    port directory, whose event leaf was a 0-d ``.comp/.event``, still read
    by the port.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from benchmarks import common as jcommon
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.checkpoint import ResyncStore as JResyncStore
from repro.checkpoint import load_checkpoint as j_load
from repro.checkpoint import save_checkpoint as j_save
from repro.core import Simulator as JSimulator
from repro.core import ring as jring
from repro_torch import paper_problem as tproblem
from repro_torch.checkpoint import (
    CheckpointManager, ResyncStore, latest_step, load_checkpoint, load_resync_bundle,
    save_checkpoint,
)
from repro_torch.checkpoint import _msgpack
from repro_torch.compression import ChocoChannel
from repro_torch.convert import state_from_checkpoint
from repro_torch.core import Simulator, ring
from repro_torch.core.baselines import GTHSGDState
from test_torch_simulator import _reference_indices, _reference_init

STATE_TOL = dict(rtol=1e-5, atol=1e-6)
N, B, TAU, OMEGA, SEED = 8, 16, 4, 0.5, 0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's many small ops: beside other
    test workers, a pool of one OpenMP thread per core oversubscribes the
    CPU and spins, which slows these runs by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _manifest(path):
    with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
        return f.read()


def _param_trees(seed=0):
    """(port tree, reference tree) of the same fp32 and bf16 leaves."""
    rng = np.random.default_rng(seed)
    f32 = {"w1": rng.standard_normal((3, 5)).astype(np.float32),
           "b1": rng.standard_normal(5).astype(np.float32)}
    port = {"dense": {k: torch.from_numpy(v) for k, v in f32.items()},
            "half": {k: torch.from_numpy(v).bfloat16() for k, v in f32.items()}}
    ref = {"dense": {k: jnp.asarray(v) for k, v in f32.items()},
           "half": {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in f32.items()}}
    return port, ref


def _bits(a) -> np.ndarray:
    """A leaf's raw bits: a bf16 tensor or a 2-byte void array as uint16."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16) if a.dtype == torch.bfloat16 \
            else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.kind == "V" else a


@pytest.mark.parametrize("meta", [None, {"round": 3, "tag": "x" * 40, "lr": 0.25,
                                         "flags": [True, None, -7, 2**40]}])
def test_manifests_are_msgpack_bytes(tmp_path, meta):
    """The port's manifest of a parameter tree is byte for byte the
    reference's, and each package's manifest decodes the other's way."""
    port, ref = _param_trees()
    got = _manifest(save_checkpoint(str(tmp_path / "port"), 5, port, meta))
    want = _manifest(j_save(str(tmp_path / "ref"), 5, ref, meta))
    assert got == want
    assert _msgpack.unpackb(want) == msgpack.unpackb(want)
    assert _msgpack.packb(msgpack.unpackb(want)) == want
    manifest = _msgpack.unpackb(got)
    assert manifest["dtypes"] == ["float32", "float32", "bfloat16", "bfloat16"]
    assert manifest["paths"] == ["['dense']/['b1']", "['dense']/['w1']",
                                 "['half']/['b1']", "['half']/['w1']"]


def test_msgpack_values_match_the_package():
    values = [None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2**32, 2**64 - 1, -1, -32,
              -33, -128, -129, -32768, -32769, -2**31 - 1, -2**63, 1.5, -0.0, "", "a" * 31,
              "a" * 32, "a" * 256, "a" * 70000, "é", b"xy", b"z" * 300, [1] * 15, [1] * 16,
              [1] * 70000, {"k": [1, {"n": None}]}, {str(i): i for i in range(16)},
              {str(i): i for i in range(70000)}, (1, 2)]
    for v in values:
        data = msgpack.packb(v)
        assert _msgpack.packb(v) == data, v if len(repr(v)) < 60 else type(v)
        assert _msgpack.unpackb(data) == msgpack.unpackb(data)
    assert _msgpack.unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5
    for bad in (b"\xc1", b"\x92\x01", b"\x01\x02"):
        with pytest.raises(ValueError):
            _msgpack.unpackb(bad)
    with pytest.raises(TypeError):
        _msgpack.packb({"x": object()})
    with pytest.raises(OverflowError):
        _msgpack.packb(2**64)


def test_parameter_trees_cross_both_ways(tmp_path):
    port, ref = _param_trees(1)
    save_checkpoint(str(tmp_path / "port"), 2, port)
    j_save(str(tmp_path / "ref"), 2, ref)
    # the reference reads the port's checkpoint (bf16 as 2-byte voids)
    tree, meta = j_load(str(tmp_path / "port"), like=ref)
    assert meta == {}
    for group in ("dense", "half"):
        for k, t in port[group].items():
            assert np.array_equal(_bits(tree[group][k]), _bits(t)), (group, k)
    assert np.asarray(tree["half"]["w1"]).dtype.kind == "V"
    # the port reads the reference's, bf16 as torch.bfloat16
    for like in (port, None):
        got, _ = load_checkpoint(str(tmp_path / "ref"), like=like, device="cpu")
        for group in ("dense", "half"):
            for k, t in port[group].items():
                assert got[group][k].dtype == t.dtype, (group, k)
                assert torch.equal(got[group][k], t), (group, k)


def test_like_with_another_layout_raises(tmp_path):
    port, _ = _param_trees()
    save_checkpoint(str(tmp_path), 0, port)
    with pytest.raises(ValueError, match="leaf 0 differs"):
        load_checkpoint(str(tmp_path), like={"other": port["dense"]}, device="cpu")
    with pytest.raises(ValueError, match="has 4 leaves and `like` has 2"):
        load_checkpoint(str(tmp_path), like={"dense": port["dense"]}, device="cpu")
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "empty"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_checkpoint(str(tmp_path))


def test_failed_save_leaves_the_last_checkpoint(tmp_path):
    port, _ = _param_trees()
    save_checkpoint(str(tmp_path), 1, port)
    with pytest.raises(TypeError):
        save_checkpoint(str(tmp_path), 2, port, {"bad": object()})
    assert sorted(os.listdir(tmp_path)) == ["step_0000000001"]
    assert latest_step(str(tmp_path)) == 1


def _reference_sim(**kw):
    data, _ = jcommon.make_paper_problem(OMEGA, seed=SEED)
    alg = jcommon.make_algorithm("dse_mvr", 0.3, TAU, 24, **kw)
    return JSimulator(alg, jring(N), jcommon.mlp_loss, data, batch_size=B), data


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """Three CHOCO top-k rounds in the reference, saved; the port loads the
    checkpoint and runs three more rounds from the reference's indices,
    each round held against the reference's own continuation."""
    kw = dict(channel="choco", compression="top_k:0.1")
    jsim, data = _reference_sim(**kw)
    key = jax.random.key(SEED + 1)
    state = jsim.init_state(jcommon.mlp_init(jax.random.key(SEED)), key)
    state, k = jsim.run_rounds(state, key, 3)
    j_save(str(tmp_path), 3, state, {"round": 3})
    want = []
    for _ in range(3):
        state, k = jsim.run_rounds(state, k, 1)
        want.append(state)

    tree, meta = load_checkpoint(str(tmp_path), device="cpu")
    assert meta == {"round": 3} and ".key" in tree[".comp"]
    got = state_from_checkpoint(tree, "cpu")
    assert got.step == 3 * TAU and got.comp.event == 0 and len(got.comp.wire) == 2
    idx = _reference_indices(key, 6 * TAU, N, B, data.samples_per_node)
    alg = tproblem.make_algorithm("dse_mvr", 0.3, TAU, 24, **kw)
    sim = Simulator(alg, ring(N), tproblem.mlp_loss, data, B, device="cpu",
                    index_fn=lambda s: idx[s])
    for r, ref in enumerate(want):
        got = sim.run_rounds(got, 1)
        assert got.step == int(ref.step) == (4 + r) * TAU
        for field in ("params", "x_ref", "v", "y", "h_prev"):
            for leaf, t in getattr(got, field).items():
                np.testing.assert_allclose(t.numpy(), np.asarray(getattr(ref, field)[leaf]),
                                           **STATE_TOL,
                                           err_msg=f"round {r} {field} {leaf}")
        for b, wire in enumerate(got.comp.wire):
            for leaf, t in wire["hat"].items():
                np.testing.assert_allclose(t.numpy(), np.asarray(ref.comp.wire[b]["hat"][leaf]),
                                           **STATE_TOL, err_msg=f"round {r} hat {b} {leaf}")


@pytest.mark.parametrize("channel", ["choco", "overlap", "none"])
def test_port_state_round_trip(tmp_path, channel):
    """A port state after two rounds, saved and loaded with ``like=``: every
    leaf, the wire's in-flight payload, the step and the event bit for bit;
    without ``like`` the same state comes back through
    ``state_from_checkpoint`` where no payload is in flight."""
    data, _ = tproblem.make_paper_problem(OMEGA, seed=SEED)
    kw = {"choco": dict(channel="choco", compression="top_k:0.1"),
          "overlap": dict(channel=ChocoChannel(overlap=True), compression="top_k:0.1"),
          "none": {}}[channel]
    alg = tproblem.make_algorithm("dse_mvr", 0.3, TAU, 16, **kw)
    idx = torch.randint(0, data.samples_per_node, (3 * TAU, N, B),
                        generator=torch.Generator().manual_seed(1))
    sim = Simulator(alg, ring(N), tproblem.mlp_loss, data, B, device="cpu",
                    index_fn=lambda s: idx[s])
    state = sim.run_rounds(sim.init_state(tproblem.mlp_init(0)), 2)
    save_checkpoint(str(tmp_path), 2, state)
    manifest = _msgpack.unpackb(_manifest(tmp_path / "step_0000000002"))
    paths = manifest["paths"]
    assert paths[0] == ".params/['b1']" and ".step" in paths
    if channel != "none":
        # the event sits where the reference keeps its key: uint32 [0, event]
        assert ".comp/.wire/[0]/['hat']/['w1']" in paths and paths[-1] == ".comp/.key"
        assert manifest["event_keys"] == [".comp/.key"]
        assert manifest["dtypes"][-1] == "uint32" and manifest["shapes"][-1] == [2]
        with np.load(tmp_path / "step_0000000002" / "data.npz") as npz:
            assert npz[f"leaf_{len(paths) - 1}"].tolist() == [0, state.comp.event] == [0, 2]
    else:
        assert "event_keys" not in manifest
    loaded, _ = load_checkpoint(str(tmp_path), like=state, device="cpu")
    assert loaded.step == state.step == 2 * TAU and type(loaded.step) is int

    def same(a, b, where):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), where
        elif isinstance(a, dict):
            assert a.keys() == b.keys(), where
            for k in a:
                same(a[k], b[k], f"{where}/{k}")
        elif isinstance(a, (tuple, list)):
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{where}[{i}]")
        elif dataclasses.is_dataclass(a):
            for f in dataclasses.fields(a):
                same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
        else:
            assert a == b, where

    same(loaded, state, "state")
    tree, _ = load_checkpoint(str(tmp_path), device="cpu")
    if channel == "overlap":
        with pytest.raises(ValueError, match="like="):
            state_from_checkpoint(tree, "cpu")
    else:
        same(state_from_checkpoint(tree, "cpu"), state, "state")
    # the resumed run is the uninterrupted one, bit for bit
    same(sim.run_rounds(loaded, 1), sim.run_rounds(state, 1), "resumed")


def test_state_class_comes_from_the_saved_fields(tmp_path):
    data, _ = tproblem.make_paper_problem(OMEGA, seed=SEED)
    alg = tproblem.make_algorithm("gt_hsgd", 0.3, TAU, 8)
    sim = Simulator(alg, ring(N), tproblem.mlp_loss, data, B, device="cpu")
    state = sim.run_rounds(sim.init_state(tproblem.mlp_init(0)), 2)
    save_checkpoint(str(tmp_path), 2, state)
    got = state_from_checkpoint(load_checkpoint(str(tmp_path), device="cpu")[0], "cpu")
    assert type(got) is GTHSGDState and got.step == 2 and got.comp is None
    for f in ("params", "v", "y"):
        for k, t in getattr(state, f).items():
            assert torch.equal(getattr(got, f)[k], t), (f, k)
    with pytest.raises(ValueError, match="no state class"):
        state_from_checkpoint({".params": {}, ".nope": {}}, "cpu")


def test_manager_keeps_the_newest(tmp_path):
    port, ref = _param_trees()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 5, 3, 7):
        mgr.save(step, port, {"step": step})
    assert sorted(os.listdir(tmp_path)) == ["step_0000000005", "step_0000000007"]
    tree, meta = mgr.restore(like=port, device="cpu")
    assert meta == {"step": 7} and torch.equal(tree["half"]["w1"], port["half"]["w1"])
    assert mgr.restore(step=5, device="cpu")[1] == {"step": 5}
    # the reference's manager reads the port's directory
    assert JCheckpointManager(str(tmp_path)).restore(like=ref)[1] == {"step": 7}


def test_resync_bundles_round_trip(tmp_path):
    rng = np.random.default_rng(3)
    leaves = [rng.standard_normal((4, 3)).astype(np.float32),
              torch.arange(6, dtype=torch.int32), torch.ones(2, 2).bfloat16()]
    key = np.array([7, 9], np.uint32)
    store = ResyncStore(str(tmp_path / "port"), keep=2, device="cpu")
    for r in range(4):
        store.save(r, leaves, key, {"epoch": r})
    assert sorted(os.listdir(tmp_path / "port")) == ["step_0000000002", "step_0000000003"]
    got, got_key, round_, meta = store.load()
    assert round_ == 3 and meta == {"n_leaves": 3, "epoch": 3}
    assert torch.equal(got[0], torch.from_numpy(leaves[0])) and torch.equal(got[1], leaves[1])
    assert got[2].dtype == torch.bfloat16 and torch.equal(got[2], leaves[2])
    assert got_key.tolist() == key.tolist()
    assert load_resync_bundle(str(tmp_path / "port"), 2, device="cpu")[3]["epoch"] == 2
    # each package reads the other's bundles
    jleaves, jkey, jround, _ = JResyncStore(str(tmp_path / "port")).load()
    assert jround == 3 and np.array_equal(jleaves[0], leaves[0])
    assert np.array_equal(np.asarray(jkey), key)
    JResyncStore(str(tmp_path / "ref")).save(1, [leaves[0]], key)
    back, back_key, _, _ = load_resync_bundle(str(tmp_path / "ref"), device="cpu")
    assert torch.equal(back[0], torch.from_numpy(leaves[0])) and back_key.tolist() == [7, 9]
    with pytest.raises(FileNotFoundError):
        load_resync_bundle(str(tmp_path / "none"), device="cpu")


def _port_state_and_reference(tmp_path, rounds, **kw):
    """A port DSE-MVR state after ``rounds`` rounds from the reference's
    initial parameters and indices, saved; the reference's Simulator, its
    state from the port's checkpoint (``like=`` its own initial state) and
    the data."""
    jsim, data = _reference_sim(**kw)
    key = jax.random.key(SEED + 1)
    idx = _reference_indices(key, rounds * TAU, N, B, data.samples_per_node)
    alg = tproblem.make_algorithm("dse_mvr", 0.3, TAU, 24, **kw)
    sim = Simulator(alg, ring(N), tproblem.mlp_loss, data, B, device="cpu",
                    index_fn=lambda s: idx[s])
    state = sim.run_rounds(sim.init_state(_reference_init(SEED)), rounds)
    save_checkpoint(str(tmp_path), rounds, state, {"round": rounds})
    like = jsim.init_state(jcommon.mlp_init(jax.random.key(SEED)), key)
    loaded, meta = j_load(str(tmp_path), like=like)
    assert meta == {"round": rounds}
    return state, alg, jsim, loaded, data


def _same_as_port(jtree, ttree, where):
    for k, t in ttree.items():
        assert np.array_equal(np.asarray(jtree[k]), t.numpy()), f"{where} {k}"


def test_reference_resumes_a_port_choco_checkpoint(tmp_path):
    """The reference loads a port CHOCO top-k state and runs a round from
    it; top-k draws nothing, so from the same indices the round lands
    within the one-round band of the port's own next round."""
    kw = dict(channel="choco", compression="top_k:0.1")
    state, alg, jsim, loaded, data = _port_state_and_reference(tmp_path, 2, **kw)
    assert int(loaded.step) == state.step == 2 * TAU
    assert jax.random.key_data(loaded.comp.key).tolist() == [0, state.comp.event] == [0, 2]
    for field in ("params", "x_ref", "v", "y", "h_prev"):
        _same_as_port(getattr(loaded, field), getattr(state, field), field)
    for b, wire in enumerate(state.comp.wire):
        _same_as_port(loaded.comp.wire[b]["hat"], wire["hat"], f"hat {b}")

    key = jax.random.key(SEED + 7)
    ref, _ = jsim.run_rounds(loaded, key, 1)
    idx = _reference_indices(key, TAU, N, B, data.samples_per_node)
    sim = Simulator(alg, ring(N), tproblem.mlp_loss, data, B, device="cpu",
                    index_fn=lambda s: idx[s - 2 * TAU])
    got = sim.run_rounds(state, 1)
    assert got.step == int(ref.step) == 3 * TAU
    for field in ("params", "x_ref", "v", "y", "h_prev"):
        for leaf, t in getattr(got, field).items():
            np.testing.assert_allclose(t.numpy(), np.asarray(getattr(ref, field)[leaf]),
                                       **STATE_TOL, err_msg=f"{field} {leaf}")
    for b, wire in enumerate(got.comp.wire):
        for leaf, t in wire["hat"].items():
            np.testing.assert_allclose(t.numpy(), np.asarray(ref.comp.wire[b]["hat"][leaf]),
                                       **STATE_TOL, err_msg=f"hat {b} {leaf}")
    # the port reads its own key leaf back as the event, and the
    # reference's (threefry words, no event count) as event 0
    back, _ = load_checkpoint(str(tmp_path), like=state, device="cpu")
    assert back.comp.event == 2
    j_save(str(tmp_path / "ref"), 3, ref)
    from_ref, _ = load_checkpoint(str(tmp_path / "ref"), like=got, device="cpu")
    assert from_ref.comp.event == 0 and from_ref.step == 3 * TAU


def test_reference_loads_a_port_qsgd_checkpoint(tmp_path):
    state, _, jsim, loaded, _ = _port_state_and_reference(tmp_path, 1, compression="qsgd")
    assert jax.random.key_data(loaded.comp.key).tolist() == [0, 1]
    for field in ("params", "x_ref", "v", "y", "h_prev"):
        _same_as_port(getattr(loaded, field), getattr(state, field), field)
    for b, wire in enumerate(state.comp.wire):
        _same_as_port(loaded.comp.wire[b]["res"], wire["res"], f"res {b}")
    ref, _ = jsim.run_rounds(loaded, jax.random.key(SEED + 7), 1)
    assert int(ref.step) == 2 * TAU
    assert all(np.isfinite(np.asarray(a)).all() for a in jax.tree.leaves(ref.params))


def test_older_port_event_leaf_still_loads(tmp_path):
    """A directory written before the event moved to the key's position
    (a 0-d int32 ``.comp/.event``, no ``event_keys``) loads in the port,
    with ``like=`` and through ``state_from_checkpoint``."""
    data, _ = tproblem.make_paper_problem(OMEGA, seed=SEED)
    alg = tproblem.make_algorithm("dse_mvr", 0.3, TAU, 16, channel="choco",
                                  compression="top_k:0.1")
    sim = Simulator(alg, ring(N), tproblem.mlp_loss, data, B, device="cpu")
    state = sim.run_rounds(sim.init_state(tproblem.mlp_init(0)), 3)
    step_dir = save_checkpoint(str(tmp_path), 3, state)
    manifest = _msgpack.unpackb(_manifest(step_dir))
    last = len(manifest["paths"]) - 1
    with np.load(os.path.join(step_dir, "data.npz")) as npz:
        leaves = {k: npz[k] for k in npz.files}
    leaves[f"leaf_{last}"] = np.asarray(3, np.int32)
    manifest["paths"][last] = ".comp/.event"
    manifest["dtypes"][last], manifest["shapes"][last] = "int32", []
    del manifest["event_keys"]
    with open(os.path.join(step_dir, "manifest.msgpack"), "wb") as f:
        f.write(_msgpack.packb(manifest))
    np.savez(os.path.join(step_dir, "data.npz"), **leaves)
    loaded, _ = load_checkpoint(str(tmp_path), like=state, device="cpu")
    assert loaded.comp.event == state.comp.event == 3
    assert torch.equal(loaded.comp.wire[0]["hat"]["w1"], state.comp.wire[0]["hat"]["w1"])
    tree, _ = load_checkpoint(str(tmp_path), device="cpu")
    assert state_from_checkpoint(tree, "cpu").comp.event == 3
