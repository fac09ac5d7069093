"""The port's elastic runtime (``repro_torch.runtime``) on the CPU: its unit
layer, its replay against the reference's (``repro.runtime``), bit-identity
of the split round without sockets, and real 2- and 4-process groups over
localhost sockets.

Randomness is injected where the packages are compared: the reference
draws minibatches and codec keys from JAX threefry, which the port does not
reimplement.  Its key chain is replayed (one ``split`` per iteration from
``key(seed + 1)``; the channel key ``fold_in(key(seed + 1), 0x636F)``) and
the indices, codec seeds and initial parameters are handed to the port's
``simulate_reference``.

Tolerances:
  * problem data, ``localize``, wire round trips, the split round against
    the Simulator and every elastic run against its replay: bit for bit;
  * the loss on parameters carried across: rtol 1e-6 (XLA's and ATen's
    GEMMs and softmax round differently);
  * the replay against the reference's, uncompressed DSE-MVR: rtol 1e-5 /
    atol 1e-6 after each round (the repo's one-round state band; the fp32
    ulps compound little over four rounds);
  * the CHOCO top-k overlap replay against the reference's: each leaf
    within 2e-2 of its largest magnitude (ROADMAP queue 3's band: an ulp
    can swap a near-tie at the k-th magnitude, and the replicas carry it).

Worker processes run on the CPU with one torch thread each.
"""
import json
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from repro.runtime import replay as jreplay
from repro.runtime.config import RuntimeConfig as JRuntimeConfig
from repro.runtime.problems import localize as j_localize
from repro.runtime.problems import make_problem as j_make_problem
from repro_torch.convert import params_from_numpy
from repro_torch.core import make_algorithm
from repro_torch.runtime import ElasticResult, RuntimeConfig, launch, owned_nodes
from repro_torch.runtime import replay_scenario, simulate_reference
from repro_torch.runtime import worker as tworker
from repro_torch.runtime.chaos import ChaosController, ChaosEvent, by_round
from repro_torch.runtime.coordinator import base_scenario
from repro_torch.runtime.engine import (
    WorkerEngine, packed_transport, restore_wire_leaves, wire_leaves,
)
from repro_torch.runtime.problems import localize, make_problem
from repro_torch.runtime.replay import leaves_equal
from repro_torch.scenarios import renormalize_dropout
from repro_torch.telemetry import trace_index
from repro_torch.tree import tree_map
from test_torch_compression import CHANNEL_TAG, _reference_seed_fn
from test_torch_simulator import _reference_indices

STATE_TOL = dict(rtol=1e-5, atol=1e-6)
CHOCO_BAND = 2e-2
SMALL = RuntimeConfig(n_nodes=4, n_rounds=4, batch_size=4, device="cpu")
CHOCO = (("lr", 0.05), ("tau", 4), ("alpha", 0.1), ("channel", "choco"),
         ("compression", "top_k:0.25"), ("overlap", True))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's many small ops: beside other
    test workers, a pool of one OpenMP thread per core oversubscribes the
    CPU and spins, which slows these runs by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _can_spawn() -> bool:
    try:
        out = subprocess.run([sys.executable, "-c", "print('ok')"], capture_output=True,
                             timeout=60)
        return out.returncode == 0
    except Exception:
        return False


needs_spawn = pytest.mark.skipif(not _can_spawn(), reason="subprocess spawning unavailable")


def _assert_bitwise(got, want):
    ok, bad = leaves_equal(got, want, verbose=True)
    assert ok, f"first differing leaf: {bad}"


# ----------------------------------------------------------------- unit layer
def test_owned_nodes_contiguous_total():
    for n_nodes, n_workers in ((8, 4), (8, 3), (5, 5), (7, 2)):
        blocks = [owned_nodes(n_nodes, n_workers, w) for w in range(n_workers)]
        np.testing.assert_array_equal(np.concatenate(blocks), np.arange(n_nodes))
    with pytest.raises(ValueError):
        owned_nodes(4, 5, 0)
    with pytest.raises(ValueError):
        owned_nodes(4, 2, 2)


def test_runtime_config_hyper_roundtrip():
    cfg = SMALL.with_(hyper={"tau": 2, "lr": 0.1, "alpha": 0.3})
    assert cfg.hyperparams == {"tau": 2, "lr": 0.1, "alpha": 0.3}
    assert isinstance(cfg.hyper, tuple)          # stays hashable/picklable
    out = cfg.to_config()
    assert out["n_nodes"] == 4 and out["device"] == "cpu"
    assert RuntimeConfig().device == "cuda"
    # the reference's fields, defaults and order, plus the device
    want = JRuntimeConfig().to_config()
    got = RuntimeConfig().to_config()
    assert list(got) == list(want) + ["device"]
    assert {k: got[k] for k in want} == want


@pytest.mark.parametrize("mesh", [dict(jax_distributed=True), dict(host_devices=2)])
def test_runtime_config_refuses_a_device_mesh(mesh):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        RuntimeConfig(**mesh)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        SMALL.with_(**mesh)


def test_kill_chaos_on_a_distributed_group_is_refused():
    """The reference refuses kill/rejoin chaos with ``jax_distributed``; the
    port refuses the group itself, before any process starts."""
    with pytest.raises(NotImplementedError, match="item 8"):
        launch(SMALL.with_(jax_distributed=True), 2,
               plan=(ChaosEvent(round=1, action="kill", worker=1),))


def _choco_engine():
    return WorkerEngine(SMALL.with_(hyper=CHOCO), 0, 2)


def test_wire_leaves_roundtrip_choco_overlap_state():
    """A CHOCO-overlap DSE-MVR state crosses the wire whole: every tensor
    bit for bit, the host step and the channel's event included (a resynced
    worker must continue the codec's seed stream), with the ``['fly']``
    payload and the stacked leaves masked by the checkpoint's flatten."""
    eng = _choco_engine()
    state, key = eng.init_state()
    n = eng.n_nodes
    for r in range(2):   # two rounds: event 2, a payload in flight
        post, key = eng.run_local(state, key, np.ones((3, n), bool))
        key, last = eng.sample_comm_batch(key)
        state = eng.run_comm(post, last, (np.eye(n, dtype=np.float32), np.ones(n, bool),
                                          np.ones((3, n), bool), 0, None, None))
    assert (state.step, state.comp.event, key) == (8, 2, 8)
    wires = wire_leaves(state)
    assert all(isinstance(a, np.ndarray) for a in wires)
    back = restore_wire_leaves(state, wires)
    assert back.step == 8 and back.comp.event == 2
    _assert_bitwise(wire_leaves(back), wires)
    fly, stacked = eng.fly_mask(state), eng.stacked_mask(state)
    assert sum(fly) >= 4 and all(s for f, s in zip(fly, stacked) if f)
    assert len(eng.scalar_leaves(state)) == 2      # the step and the event
    np.testing.assert_array_equal(eng.scalar_leaves(state)[1], np.array([0, 2], np.uint32))
    # the gather and payload overwrites put rows back where they came from
    rows = [a for a, m in zip(wires, stacked) if m]
    _assert_bitwise(wire_leaves(eng.set_stacked(state, rows)), wires)
    _assert_bitwise(wire_leaves(eng.set_fly(state, [a for a, m in zip(wires, fly) if m])), wires)
    owned = np.asarray(eng.owned)
    for got, full in zip(eng.owned_rows(state), rows):
        np.testing.assert_array_equal(got, full[owned])
    with pytest.raises(ValueError):
        restore_wire_leaves(state, wires[:-1])
    with pytest.raises(ValueError):
        eng.set_stacked(state, rows + rows[:1])


def test_packed_transport_eligibility():
    yes = make_algorithm("dse_mvr", lr=0.05, tau=2, alpha=0.1, channel="choco",
                         compression="top_k:0.25", overlap=True)
    assert packed_transport(yes)
    no_overlap = make_algorithm("dse_mvr", lr=0.05, tau=2, alpha=0.1, channel="choco",
                                compression="top_k:0.25")
    assert not packed_transport(no_overlap)
    assert not packed_transport(make_algorithm("dse_mvr", lr=0.05, tau=2, alpha=0.1))


def test_chaos_plan_validation():
    with pytest.raises(ValueError):
        ChaosEvent(round=0, action="explode", worker=0)
    plan = (ChaosEvent(round=2, action="kill", worker=1),
            ChaosEvent(round=2, action="sleep", worker=0, seconds=0.5),
            ChaosEvent(round=4, action="rejoin", worker=1))
    grouped = by_round(plan)
    assert sorted(grouped) == [2, 4] and len(grouped[2]) == 2


@needs_spawn
def test_chaos_controller_kill_and_respawn():
    ctl = ChaosController(
        lambda wid: subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"]))
    try:
        ctl.spawn(0)
        assert ctl.is_running(0)
        with pytest.raises(RuntimeError):
            ctl.spawn(0)          # already running
        ctl.kill(0)
        assert not ctl.is_running(0)
        ctl.spawn(0)              # respawn after death is fine
        assert ctl.is_running(0)
    finally:
        ctl.shutdown(timeout_s=0.5)   # the sleeper never exits by itself
    assert not ctl.procs


def test_worker_control_socket_has_no_read_timeout(monkeypatch):
    """The dial keeps ``connect_with_retry``'s 10 s, but the connected
    control socket waits in ``recv`` without a limit: a survivor must not
    time out while the coordinator admits a slow rejoin."""
    dialed = []
    real = tworker.connect_with_retry

    def spy(address):
        conn = real(address)
        assert conn.sock.gettimeout() == 10.0
        dialed.append(conn)
        return conn

    monkeypatch.setattr(tworker, "connect_with_retry", spy)
    server = socket.create_server(("127.0.0.1", 0))
    seen = {}

    def coordinator():
        raw, _ = server.accept()
        with raw:
            raw.recv(1 << 16)         # the hello, sent once the dial is done
            seen["timeout"] = dialed[0].sock.gettimeout()
        # hang up: no welcome

    t = threading.Thread(target=coordinator)
    t.start()
    try:
        with pytest.raises(RuntimeError, match="expected welcome"):
            tworker.run_worker(f"127.0.0.1:{server.getsockname()[1]}", 0)
    finally:
        t.join(timeout=30)
        server.close()
    assert seen["timeout"] is None and dialed[0].sock.gettimeout() is None


# ------------------------------------------------- parity with the reference
@pytest.mark.parametrize("name", ["mlp_blobs", "pseudo_mnist"])
def test_problem_data_and_localize_match_reference(name):
    t, j = make_problem(name, 8, 3), j_make_problem(name, 8, 3)
    np.testing.assert_array_equal(t.data.x, j.data.x)
    np.testing.assert_array_equal(t.data.y, j.data.y)
    assert t.data.n_dropped == j.data.n_dropped
    for w in range(3):
        owned = owned_nodes(8, 3, w)
        tl, jl = localize(t.data, owned), j_localize(j.data, owned)
        np.testing.assert_array_equal(tl.x, jl.x)
        np.testing.assert_array_equal(tl.y, jl.y)


def _reference_init(name, n_nodes, seed):
    """The reference problem's initial parameters, as numpy."""
    prob = j_make_problem(name, n_nodes, seed)
    return jax.tree.map(np.asarray, prob.init_params(jax.random.key(seed)))


@pytest.mark.parametrize("name", ["mlp_blobs", "pseudo_mnist"])
def test_problem_loss_matches_reference(name):
    n, b, seed = 4, 8, 1
    j, t = j_make_problem(name, n, seed), make_problem(name, n, seed)
    init = _reference_init(name, n, seed)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, j.data.samples_per_node, (n, b))
    rows = np.arange(n)[:, None]
    x, y = j.data.x[rows, idx], j.data.y[rows, idx]
    stacked = {k: np.repeat(v[None], n, 0) + rng.normal(size=(n,) + v.shape).astype(np.float32)
               * 0.01 for k, v in init.items()}
    want = np.asarray(jax.vmap(j.loss_fn)(jax.tree.map(jax.numpy.asarray, stacked), (x, y)))
    got = t.loss_fn(params_from_numpy(stacked, "cpu"),
                    (torch.from_numpy(x), torch.from_numpy(y).long()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # the port's own init: a seeded CPU generator, the same on every call
    a, b2 = t.init_params(seed), t.init_params(seed)
    assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in init.items()}
    assert all(torch.equal(a[k], b2[k]) for k in a)


def test_lm_problem_default_arch_refused_in_both_and_explicit_arch_built():
    """The reference's ``lm`` defaults to ``arch="dense_moe"``, which no
    config registry knows: both packages refuse it (ROADMAP queue 3).  With
    a ported arch both build the same token shards, and the port's loss is
    one finite value a node."""
    with pytest.raises(ModuleNotFoundError):
        j_make_problem("lm", 2, 0)
    with pytest.raises(ModuleNotFoundError):
        make_problem("lm", 2, 0)
    kw = dict(arch="gemma2_2b", seq_len=8, samples_per_node=2)
    j, t = j_make_problem("lm", 2, 0, **kw), make_problem("lm", 2, 0, **kw)
    np.testing.assert_array_equal(t.data.x, j.data.x)
    np.testing.assert_array_equal(t.data.y, j.data.y)
    stacked = tree_map(lambda p: p.unsqueeze(0).repeat((2,) + (1,) * p.dim()), t.init_params(0))
    loss = t.loss_fn(stacked, (torch.from_numpy(t.data.x[:, :1]),
                               torch.from_numpy(t.data.y[:, :1])))
    assert loss.shape == (2,) and torch.isfinite(loss).all()


def _reference_inputs(cfg, n_steps):
    """The reference replay's indices, codec seeds and initial parameters."""
    key = jax.random.key(cfg.seed + 1)
    prob = j_make_problem(cfg.problem, cfg.n_nodes, cfg.seed)
    idx = _reference_indices(key, n_steps, cfg.n_nodes, cfg.batch_size,
                             prob.data.samples_per_node)
    seed_fn = _reference_seed_fn(jax.random.fold_in(key, CHANNEL_TAG), n_steps, 2, 4)
    init = params_from_numpy(_reference_init(cfg.problem, cfg.n_nodes, cfg.seed), "cpu")
    return (lambda s: idx[s]), seed_fn, init


def _float_leaves(leaves):
    return [np.asarray(a) for a in leaves if np.asarray(a).dtype.kind == "f"]


@pytest.mark.parametrize("hyper", [None, CHOCO], ids=["uncompressed", "choco_top_k_overlap"])
def test_simulate_reference_matches_reference_replay(hyper):
    """The same dropout log through both packages' replays, from the
    reference's indices, codec seeds and initial parameters, after each of
    four rounds."""
    kw = {} if hyper is None else dict(hyper=hyper)
    tcfg, jcfg = SMALL.with_(**kw), JRuntimeConfig(n_nodes=4, n_rounds=4, batch_size=4, **kw)
    log = np.ones((4, 4), bool)
    log[1:3, 3] = False
    log[2, 0] = False
    index_fn, seed_fn, init = _reference_inputs(tcfg, 4 * 4)
    for r in range(1, 5):
        want = jreplay.simulate_reference(jcfg.with_(n_rounds=r), log[:r])
        got = simulate_reference(tcfg.with_(n_rounds=r), log[:r], device="cpu",
                                 index_fn=index_fn, comm_seed_fn=seed_fn, init_params=init)
        assert got["state"].step == int(want["state"].step) == 4 * r
        gl, wl = _float_leaves(got["wire_leaves"]), _float_leaves(want["wire_leaves"])
        assert [a.shape for a in gl] == [a.shape for a in wl]
        for i, (a, b) in enumerate(zip(gl, wl)):
            if hyper is None:
                np.testing.assert_allclose(a, b, **STATE_TOL, err_msg=f"round {r} leaf {i}")
            else:
                scale = max(float(np.abs(b).max()), 1e-30)
                assert float(np.abs(a - b).max()) <= CHOCO_BAND * scale, (r, i)


# ------------------------------------------- bit-identity without sockets
def test_split_round_bit_identical_to_simulator():
    """Two engines (workers 0 and 1 of 2) each run the local phase; their
    owned rows are assembled as the coordinator's ``_assemble`` does, each
    runs the comm phase on the assembly, and the canonical state (owner
    rows, inactive rows frozen) equals the Simulator's under RecordedFaults
    bit for bit after every round, with node 1 dropped in round 1."""
    cfg = SMALL.with_(n_rounds=3)
    log = np.ones((3, 4), bool)
    log[1, 1] = False
    engines = [WorkerEngine(cfg, w, 2) for w in range(2)]
    sched = base_scenario(cfg).materialize(4, 3, engines[0].round_len, cfg.batch_size)
    states = [e.init_state() for e in engines]
    stacked = engines[0].stacked_mask(states[0][0])
    canonical = wire_leaves(states[0][0])
    for r in range(3):
        active = sched.active[r] & log[r]
        w = renormalize_dropout(sched.w[r].astype(np.float64), active).astype(np.float32)
        lm = sched.local_mask[r] & active[None, :]
        posts = [e.run_local(s, k, lm) for e, (s, k) in zip(engines, states)]
        lasts = [e.sample_comm_batch(k) for e, (_, k) in zip(engines, posts)]
        # the coordinator's _assemble: owner rows over the canonical, and
        # the last batch from its owners' rows
        full = [np.array(canonical[i], copy=True) for i, m in enumerate(stacked) if m]
        x, y = (np.zeros((4,) + a.shape[1:], a.dtype) for a in engines[0].owned_batch(lasts[0][1]))
        for e, (post, _), (_, last) in zip(engines, posts, lasts):
            for j, rows in enumerate(e.owned_rows(post)):
                full[j][e.owned] = rows
            x[e.owned], y[e.owned] = e.owned_batch(last)
        row = (w, active, lm, int(sched.pattern[r]), None, None)
        outs = [e.run_comm(e.set_stacked(post, full), (x, y), row)
                for e, (post, _) in zip(engines, posts)]
        new = [np.array(a, copy=True) for a in wire_leaves(outs[0])]
        for e, out in zip(engines, outs):
            leaves = wire_leaves(out)
            for i, m in enumerate(stacked):
                if m:
                    new[i][e.owned] = leaves[i][e.owned]
        for i, m in enumerate(stacked):
            if m:
                new[i][~active] = canonical[i][~active]
        canonical = new
        states = [(out, k) for out, (k, _) in zip(outs, lasts)]
        ref = simulate_reference(cfg.with_(n_rounds=r + 1), log[: r + 1], device="cpu")
        _assert_bitwise(canonical, ref["wire_leaves"])


# -------------------------------------------------------------- process layer
@needs_spawn
def test_elastic_2proc_no_fault_bit_identical(tmp_path):
    """Fault-free 2-process group: stable membership, the run bitwise its
    replay (through an all-true recorded log), and every worker's records
    and the coordinator's runtime streams in one run-stamped JSONL."""
    stream = str(tmp_path / "telemetry.jsonl")
    res = launch(SMALL, 2, stream_path=stream)
    assert isinstance(res, ElasticResult)
    assert res.epochs == [0] * SMALL.n_rounds
    assert res.active_log.all() and res.resync_seconds == []
    ref = simulate_reference(SMALL, res.active_log, device="cpu")
    _assert_bitwise(res.final_leaves, ref["wire_leaves"])
    assert int(res.final_key) == int(ref["key"]) == 16

    with open(stream) as f:
        lines = [json.loads(line) for line in f]
    assert lines[0]["event"] == "meta"
    procs = {line["run"]["process"] for line in lines if "run" in line}
    assert {"coordinator", "worker:0", "worker:1"} <= procs
    streams = {line.get("stream") for line in lines}
    assert {"membership_epoch", "active_workers", "round_seconds", "contrib_seconds"} <= streams
    assert all("pid" in line["run"] for line in lines if "run" in line)


@needs_spawn
def test_elastic_kill_rejoin_bit_identical():
    """Worker 1 is SIGKILLed before round 1 and respawned before round 3:
    its nodes drop out (renormalized W_t), the rejoin resyncs through the
    on-disk bundle, the epochs bump at both transitions and nowhere else
    (the survivor never drops), and the run is bitwise its replay."""
    cfg = SMALL.with_(n_rounds=5)
    plan = (ChaosEvent(round=1, action="kill", worker=1),
            ChaosEvent(round=3, action="rejoin", worker=1))
    res = launch(cfg, 2, plan=plan)
    expected = np.ones((5, 4), dtype=bool)
    expected[1:3, 2:] = False                 # worker 1 owns nodes 2..3
    np.testing.assert_array_equal(res.active_log, expected)
    assert res.epochs == [0, 1, 1, 2, 2]
    assert len(res.resync_seconds) == 1       # the rejoin resync
    assert res.startup_seconds > 0 and len(res.join_seconds) == 1
    assert res.join_seconds[0] >= res.resync_seconds[0]

    alg = make_algorithm(cfg.algorithm, **cfg.hyperparams)
    sched = replay_scenario(cfg, res.active_log).materialize(
        cfg.n_nodes, cfg.n_rounds, alg.comm.round_len(alg.tau))
    w = sched.w[1].astype(np.float64)
    np.testing.assert_allclose(w.sum(0), 1.0, atol=1e-5)
    np.testing.assert_allclose(w.sum(1), 1.0, atol=1e-5)
    assert w[2, 2] == 1.0 and w[3, 3] == 1.0
    assert np.all(w[2, :2] == 0.0) and np.all(w[:2, 3] == 0.0)

    ref = simulate_reference(cfg, res.active_log, device="cpu")
    _assert_bitwise(res.final_leaves, ref["wire_leaves"])


@needs_spawn
def test_elastic_4proc_kill_straggler_rejoin(tmp_path):
    """4 processes, 8 nodes: a kill, a REAL straggler sleep and a rejoin.
    The straggler shows in worker 0's ``contrib_seconds`` and nobody
    else's, the survivors stay live across the rejoin, and the final state
    is bitwise the single-process replay."""
    cfg = RuntimeConfig(n_nodes=8, n_rounds=6, batch_size=4, device="cpu")
    sleep_s = 0.4
    plan = (ChaosEvent(round=2, action="kill", worker=2),
            ChaosEvent(round=3, action="sleep", worker=0, seconds=sleep_s),
            ChaosEvent(round=4, action="rejoin", worker=2))
    res = launch(cfg, 4, plan=plan, stream_path=str(tmp_path / "telemetry.jsonl"))
    expected = np.ones((6, 8), dtype=bool)
    expected[2:4, 4:6] = False                # worker 2 owns nodes 4..5
    np.testing.assert_array_equal(res.active_log, expected)
    assert res.epochs == [0, 0, 1, 1, 2, 2]   # kill + rejoin, no drop
    times = {rec["run"]["process"]: rec["value"] for rec in res.worker_records
             if rec.get("stream") == "contrib_seconds" and rec.get("step") == 3}
    assert set(times) == {"worker:0", "worker:1", "worker:3"}
    assert times["worker:0"] >= sleep_s
    assert all(v < sleep_s for p, v in times.items() if p != "worker:0")
    last = {rec["run"]["process"] for rec in res.worker_records
            if rec.get("stream") == "contrib_seconds" and rec.get("step") == 5}
    assert last == {f"worker:{w}" for w in range(4)}
    ref = simulate_reference(cfg, res.active_log, device="cpu")
    _assert_bitwise(res.final_leaves, ref["wire_leaves"])


@needs_spawn
def test_elastic_packed_parity_and_fewer_bytes():
    """The packed socket protocol is a transport rewrite: final state
    BIT-identical to the single-process replay, with fewer framed socket
    bytes than the dense contrib/gather exchange of the same config."""
    cfg = SMALL.with_(hyper=CHOCO)
    packed = launch(cfg.with_(packed_transport="auto"), 2)
    ref = simulate_reference(cfg, packed.active_log, device="cpu")
    _assert_bitwise(packed.final_leaves, ref["wire_leaves"])
    dense = launch(cfg.with_(packed_transport="off"), 2)
    _assert_bitwise(dense.final_leaves, ref["wire_leaves"])
    assert packed.socket_bytes["total"] < dense.socket_bytes["total"], (
        packed.socket_bytes, dense.socket_bytes)


@needs_spawn
def test_elastic_4proc_pause_resume_kill_rejoin_trace_and_healthz(tmp_path):
    """4 processes with a pause-induced abandoned attempt AND a kill +
    rejoin give one Perfetto-loadable trace; /healthz polled DURING the run
    sees the epoch move and the degraded state; the run is its replay."""
    from repro_torch.runtime.launch import _free_port

    cfg = RuntimeConfig(n_nodes=8, n_rounds=6, batch_size=4, heartbeat_timeout_s=2.0,
                        device="cpu")
    plan = (ChaosEvent(round=1, action="pause", worker=3),
            ChaosEvent(round=2, action="resume", worker=3),
            ChaosEvent(round=3, action="kill", worker=1),
            ChaosEvent(round=4, action="rejoin", worker=1))
    trace_path = str(tmp_path / "trace.json")
    port = _free_port()
    observed, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2) as r:
                    observed.append(json.loads(r.read()))
            except urllib.error.HTTPError as e:     # 503 while degraded
                observed.append(json.loads(e.read()))
            except OSError:
                pass                                 # not up yet / closing
            time.sleep(0.2)

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    try:
        res = launch(cfg, 4, plan=plan, trace_path=trace_path, http_port=port)
    finally:
        stop.set()
        poller.join(timeout=5)

    assert res.epochs[-1] >= 3               # pause, kill and rejoin all bumped
    assert res.diagnostics is not None and res.trace_path == trace_path
    ref = simulate_reference(cfg, res.active_log, device="cpu")
    _assert_bitwise(res.final_leaves, ref["wire_leaves"])

    assert observed, "healthz poller never reached the coordinator"
    epochs_seen = [snap["epoch"] for snap in observed]
    assert epochs_seen[-1] > min(epochs_seen)
    assert any(not snap["ok"] for snap in observed) and any(snap["ok"] for snap in observed)

    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    # coordinator + 4 original workers + the respawned worker-1 process
    assert len({e["pid"] for e in events if e["ph"] != "M"}) >= 6
    idx = trace_index(events)
    assert len(idx) == cfg.n_rounds               # one trace id per round
    assert len({t.split("/")[0] for t in idx}) == 1
    assert any(e["abandoned"] for e in idx.values()), "no abandoned round attempt"
    phases = {p for e in idx.values() for p in e["phases"]}
    assert {"round", "local", "gossip", "resync", "epoch_bump"} <= phases
    for t, entry in idx.items():
        assert len(entry["pids"]) >= 2, f"{t} not cross-process"
