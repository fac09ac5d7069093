"""The port's telemetry hub (``repro_torch.telemetry``), the Simulator's and
the request driver's telemetry plumbing and ``ServingMetrics`` against the
reference's (``repro.telemetry``, ``repro.serving.metrics``).

Tolerances:
  * the hub, its exporters, the trace stitcher, the diagnostics monitor and
    ``ServingMetrics`` on the same records: equal output (``collect()``,
    JSONL records and Prometheus text with the run metadata masked: the
    port stamps ``torch_version`` where the reference stamps
    ``jax_version``);
  * a Simulator run with a hub against the same run without one, spans on
    and off, static (CHOCO top-k) and under ``dropout_ring``: bit for bit
    (parameters, streams, history) and equal kernel dispatch counts;
  * link-byte totals against the reference Simulator's over the same run:
    equal (analytic byte counts; no codec here is event-triggered);
  * the hub's per-round streams against the reference's over the same
    indices and initial weights: the main-path band, rtol 5e-4 / atol 1e-5
    (``test_torch_scenarios``);
  * the request driver with a hub and metrics: the greedy tokens of the
    driver without them, exactly.
"""
import json
import os
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

import repro.telemetry as jtel
from benchmarks import common as jcommon
from repro.core import Simulator as JSimulator
from repro.core import ring as jring
from repro.scenarios import make_scenario as j_make_scenario
from repro.serving.metrics import ServingMetrics as JServingMetrics
import repro_torch.telemetry as ttel
from repro_torch import paper_problem as tproblem
from repro_torch.compression import link_bytes_per_round
from repro_torch.configs import get_reduced
from repro_torch.core import Simulator, ring
from repro_torch.kernels import api as tapi
from repro_torch.models import Model
from repro_torch.scenarios import STREAM_FIELDS, make_scenario
from repro_torch.serving import RequestDriver, ServingMetrics
from test_torch_simulator import _reference_indices, _reference_init

N, B, TAU, OMEGA, SEED = 8, 16, 4, 0.5, 0
RUN_RTOL, RUN_ATOL = 5e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's many small ops: beside other
    test workers, a pool of one OpenMP thread per core oversubscribes the
    CPU and spins, which slows these runs by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _masked_prometheus(text: str) -> str:
    return "\n".join(line for line in text.splitlines() if "_run_info{" not in line)


def _feed(hub, spec):
    """One record sequence covering every stream kind, axis and recorder."""
    hub.register_stream(spec("loss", kind="gauge", unit="nats", doc="training loss"))
    hub.register_stream("lat", kind="histogram", unit="s")
    hub.register_stream(spec("ages", kind="gauge", axis="node", doc="per-node ages"))
    hub.register_stream(spec("bytes_out", kind="counter", unit="B"))
    for s in range(5):
        hub.record("loss", 1.0 / (s + 1), step=s)
        hub.record("lat", 0.01 * s, step=s, label="a")
        hub.record("lat", 0.02 * s + 1e-3, step=s, label="b")
        hub.record("ages", np.arange(3) + s, step=s)
        hub.record("bytes_out", np.array([1.0, 2.0]) * s, step=s)
        hub.record_link_bytes({"params/sync": 100.0, "y/choco_top_k0.1": 7.5}, rounds=2,
                              factor=0.5, step=s)
    hub.gauge("eval/acc", 0.5, step=4)
    hub.record_many({"loss": 0.125, "eval/acc": 0.75}, step=5)
    hub.record_event({"event": "note", "x": 1})
    hub.record("span_seconds", 0.25, step=1, label="local")
    hub.record("span_seconds", 0.5, step=1, label="gossip")


@pytest.mark.parametrize("registered", ["training", "runtime", "none"])
def test_hub_matches_reference(registered, tmp_path):
    """The same records into both hubs: equal collect(), equal Prometheus
    text and equal JSONL records once the run stamp is masked, every JSONL
    record stamped with the hub's own metadata."""
    want, got = jtel.Telemetry(config={"a": 1}), ttel.Telemetry(config={"a": 1})
    for hub, mod in ((want, jtel), (got, ttel)):
        if registered == "training":
            mod.register_training_streams(hub)
        elif registered == "runtime":
            mod.register_runtime_streams(hub)
        _feed(hub, mod.StreamSpec)
    assert got.streams == want.streams
    assert json.dumps(got.collect(), sort_keys=True) == json.dumps(want.collect(), sort_keys=True)
    assert got.events == want.events
    assert _masked_prometheus(got.prometheus()) == _masked_prometheus(want.prometheus())
    assert got.total("link_bytes", "params/sync") == 500.0
    with pytest.raises(ValueError, match="conflicting"):
        got.register_stream("loss", kind="counter")
    with pytest.raises(ValueError, match="not a counter"):
        got.total("loss")

    n_got = got.export_jsonl(str(tmp_path / "got.jsonl"))
    n_want = want.export_jsonl(str(tmp_path / "want.jsonl"))
    assert n_got == n_want
    rows = {}
    for name, hub in (("got", got), ("want", want)):
        lines = [json.loads(line) for line in open(tmp_path / f"{name}.jsonl")]
        assert len(lines) == n_got and lines[0]["event"] == "meta"
        assert all(rec["run"] == hub.meta for rec in lines), name
        rows[name] = [{k: v for k, v in rec.items() if k != "run"} for rec in lines]
    assert rows["got"] == rows["want"]


def test_run_metadata_names_torch_and_leaves_cuda_alone():
    meta = ttel.run_metadata({"x": 1}, process="worker:3")
    assert meta["torch_version"] == torch.__version__
    assert meta["config_hash"] == jtel.config_hash({"x": 1})
    assert meta["process"] == "worker:3" and meta["pid"] == str(os.getpid())
    assert "jax_version" not in meta
    if not torch.cuda.is_available():
        assert meta["device_kind"] == "cpu"
        assert not torch.cuda.is_initialized()
    hub = ttel.Telemetry(meta={"git_sha": "abc"})
    assert hub.meta == {"git_sha": "abc"}
    assert 'repro_run_info{git_sha="abc"} 1' in hub.prometheus()


def test_exports_every_reference_name():
    assert set(jtel.__all__) <= set(ttel.__all__)
    for name in jtel.__all__:
        assert hasattr(ttel, name), name
    assert ttel.TRAINING_STREAM_FIELDS == jtel.TRAINING_STREAM_FIELDS == STREAM_FIELDS
    assert ttel.SERVING_STREAM_FIELDS == jtel.SERVING_STREAM_FIELDS
    assert ttel.RUNTIME_STREAM_FIELDS == jtel.RUNTIME_STREAM_FIELDS


def _span_records():
    """Stamped span and instant records of three processes, as the runtime
    drains them."""
    recs = []
    for pid, proc in ((11, "coordinator"), (12, "worker:0"), (13, "worker:1")):
        run = {"pid": str(pid), "process": proc}
        for r in range(3):
            trace = jtel.round_trace_id("run1", r)
            recs.append({"event": "span", "phase": "local", "step": r, "seconds": 0.01 * (r + 1),
                         "t0": 100.0 + r + 0.001 * pid, "trace": trace, "epoch": 0, "run": run})
            recs.append({"event": "span", "phase": "gossip", "step": r, "seconds": 0.002,
                         "t0": 100.5 + r, "trace": trace, "abandoned": r == 1, "run": run})
        recs.append({"event": "instant", "phase": "epoch", "step": 2, "t0": 102.7,
                     "to_epoch": 1, "run": run})
    recs.append({"event": "span", "phase": "eval", "step": 0, "seconds": 0.1})   # no t0
    return recs


def test_trace_stitching_matches_reference(tmp_path):
    recs = _span_records()
    got, want = ttel.trace_events(recs), jtel.trace_events(recs)
    assert got == want and len(got) == 3 + 3 * 7
    assert ttel.trace_index(got) == jtel.trace_index(want)
    assert ttel.trace_events(recs, base_ts=50.0) == jtel.trace_events(recs, base_ts=50.0)
    assert ttel.write_chrome_trace(str(tmp_path / "got.json"), recs) == len(want)
    jtel.write_chrome_trace(str(tmp_path / "want.json"), recs)
    assert json.load(open(tmp_path / "got.json")) == json.load(open(tmp_path / "want.json"))
    assert ttel.round_trace_id("abc", 7) == jtel.round_trace_id("abc", 7)
    assert len(ttel.new_run_id()) == len(jtel.new_run_id())

    # the recorder's events carry the anchors the stitcher needs
    hub = ttel.Telemetry(meta={"pid": "5", "process": "worker:2"})
    rec = ttel.TraceRecorder(hub)
    with rec.span("resync", trace="t/r00001", step=1, epoch=2) as info:
        info["abandoned"] = True
    rec.instant("kill", trace="t/r00001", step=1, worker=3)
    drained = ttel.RecordCursor(hub).drain()
    events = ttel.trace_events(drained)
    assert [e["name"] for e in events] == ["process_name", "resync", "kill"]
    assert events[1]["args"] == {"trace": "t/r00001", "epoch": 2, "abandoned": True, "round": 1}
    assert hub.labels("span_seconds") == ("resync",)


def test_diagnostics_monitor_matches_reference():
    rng = np.random.default_rng(0)
    consensus = np.concatenate([np.geomspace(1.0, 1e-3, 20), np.geomspace(1e-3, 1.0, 10)])
    loss = np.concatenate([np.linspace(2.0, 0.5, 15), np.full(10, 0.5), [np.inf, 0.5, 0.5, 0.5,
                                                                          0.5]])
    tracking = rng.random(30)
    out = {}
    for name, mod in (("got", ttel), ("want", jtel)):
        hub = mod.Telemetry(meta={"pid": "1"})
        mon = mod.DiagnosticsMonitor(hub, window=6, patience=3)
        fired = [mon.observe(t, epoch=0 if t < 20 else 1, consensus=float(consensus[t]),
                             loss=float(loss[t]), tracking_err=float(tracking[t]))
                 for t in range(30)]
        off = mod.DiagnosticsMonitor(None)
        off.observe_streams({"consensus": consensus, "tracking_err": tracking}, epochs=[0] * 30)
        out[name] = (fired, mon.diagnose(), mon.anomalies, hub.events,
                     json.dumps(hub.collect(), sort_keys=True), off.diagnose())
    assert out["got"] == out["want"]
    assert any(out["got"][0]), "no anomaly fired: the series do not exercise the rules"
    stat = ttel.OnlineStat(alpha=0.5, window=4)
    jstat = jtel.OnlineStat(alpha=0.5, window=4)
    for v in (4.0, 2.0, 1.0, 0.5, 0.25):
        stat.update(v)
        jstat.update(v)
    assert stat.summary() == jstat.summary() and stat.log_slope() == jstat.log_slope()


def test_fleet_server_routes():
    hub = ttel.Telemetry(meta={"pid": "1"})
    hub.record("span_seconds", 0.5, step=0, label="local")
    health = {"ok": True, "epoch": 3}
    server = ttel.FleetServer(
        metrics=hub.prometheus, health=lambda: health,
        trace=lambda: ttel.trace_events(_span_records()),
        diagnostics=lambda: {"steps": 0}).start()
    try:
        def get(route):
            try:
                with urllib.request.urlopen(server.url + route, timeout=10) as resp:
                    return resp.status, resp.read().decode()
            except urllib.error.HTTPError as err:
                return err.code, err.read().decode()

        status, body = get("/metrics")
        assert status == 200 and 'repro_span_seconds_count{label="local"} 1' in body
        assert get("/healthz") == (200, json.dumps(health))
        health["ok"] = False
        assert get("/healthz")[0] == 503
        status, body = get("/trace")
        assert status == 200 and json.loads(body)["traceEvents"] == ttel.trace_events(
            _span_records())
        assert get("/diagnostics") == (200, json.dumps({"steps": 0}))
        assert get("/nowhere")[0] == 404
    finally:
        server.close()
    plain = ttel.FleetServer().start()
    try:
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(plain.url + "/metrics", timeout=10)
    finally:
        plain.close()
    with pytest.raises(RuntimeError, match="not started"):
        plain.port


def test_record_kernel_launches_folds_deltas(monkeypatch):
    """The CPU launches nothing, so the counts are stood in for: each call
    records only what was launched since the last one."""
    counts = iter([{"axpby": 3, "mvr_update": 1}, {"axpby": 3, "mvr_update": 4, "add_sub": 2},
                   {"axpby": 5, "mvr_update": 4, "add_sub": 2}])
    monkeypatch.setattr(tapi, "launch_counts", lambda: next(counts))
    hub = ttel.Telemetry(meta={})
    assert hub.record_kernel_launches(step=0) == {"axpby": 3, "mvr_update": 1}
    assert hub.record_kernel_launches(step=1) == {"mvr_update": 3, "add_sub": 2}
    assert hub.record_kernel_launches(step=2) == {"axpby": 2}
    assert {op: hub.total("kernel_launches", op) for op in hub.labels("kernel_launches")} == {
        "add_sub": 2.0, "axpby": 5.0, "mvr_update": 4.0}
    steps, vals = hub.series("kernel_launches", "axpby")
    assert steps.tolist() == [0, 2] and vals.tolist() == [3.0, 2.0]


def test_spans_and_fence_are_inert_without_a_hub(tmp_path):
    t = torch.ones(3)
    with ttel.span(None, "local", step=0) as sp:
        sp.fence(t)
    off = ttel.Telemetry(meta={}, spans=False)
    with ttel.span(off, "local", step=0) as sp:
        sp.fence(t)
    assert off.labels("span_seconds") == () and off.events == []
    on = ttel.Telemetry(meta={})
    with ttel.profile_trace(str(tmp_path)):
        with ttel.span(on, "gossip", step=4) as sp:
            (t * 2).sum()
            sp.fence({"a": (t, [t]), "b": None})
    assert on.labels("span_seconds") == ("gossip",)
    assert on.events[0]["phase"] == "gossip" and on.events[0]["step"] == 4
    traces = os.listdir(tmp_path)
    assert len(traces) == 1 and traces[0].startswith("trace_")
    names = {e.get("name") for e in json.load(open(tmp_path / traces[0]))["traceEvents"]}
    assert "repro/gossip" in names
    with ttel.profile_trace(None):
        pass
    if not torch.cuda.is_available():
        assert not torch.cuda.is_initialized()


# ------------------------------------------------------------ the Simulator
def _port_run(steps, telemetry, **kw):
    """``run_method`` on the CPU through the fused ops' plain versions, from
    the reference's indices and initial weights; returns the result and the
    dispatch counts of the run."""
    data, _ = tproblem.make_paper_problem(OMEGA, seed=SEED)
    idx = _reference_indices(jax.random.key(SEED + 1), steps, N, B, data.samples_per_node)
    tapi.reset_counters()
    out = tproblem.run_method("dse_mvr", OMEGA, TAU, B, steps, seed=SEED, device="cpu",
                              use_fused=True, keep_state=True, telemetry=telemetry,
                              index_fn=lambda s: idx[s], init_params=_reference_init(SEED), **kw)
    return out, tapi.call_counts()


def _reference_hub(steps, spans, scenario=None, **kw):
    data, (xte, yte) = jcommon.make_paper_problem(OMEGA, seed=SEED)
    alg = jcommon.make_algorithm("dse_mvr", 0.3, TAU, steps, **kw)
    hub = jtel.Telemetry(spans=spans)
    sim = JSimulator(alg, jring(N) if scenario is None else None, jcommon.mlp_loss, data, B,
                     eval_fn=lambda p: {"test_acc": jcommon.accuracy(p, xte, yte)},
                     scenario=None if scenario is None else j_make_scenario(scenario),
                     telemetry=hub)
    sim.run(jcommon.mlp_init(jax.random.key(SEED)), jax.random.key(SEED + 1), steps,
            eval_every=steps)
    return hub


_CASES = {
    "choco_top_k": dict(channel="choco", compression="top_k:0.1"),
    "dropout_ring": dict(scenario="dropout_ring"),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_simulator_with_a_hub_is_bit_for_bit(case):
    """A hub, spans off or on, changes no number of the run: parameters,
    history and streams equal the telemetry-free run's bit for bit, with the
    same dispatches.  The spanned hub holds local, gossip and eval spans
    (metrics too under a scenario), the eval gauges, the link bytes of every
    round and each stream once a round, equal to the run's streams."""
    kw = dict(_CASES[case])
    scen = kw.pop("scenario", None)
    steps = 18   # four rounds and a two-step local tail
    runs = {}
    for mode in ("none", "off", "on"):
        hub = None if mode == "none" else ttel.Telemetry(spans=mode == "on")
        sc = None if scen is None else make_scenario(scen)
        runs[mode] = _port_run(steps, hub, scenario=sc, **kw) + (hub,)
    (base, calls, _), (_, _, spanned) = runs["none"], runs["on"]
    assert calls, "the run dispatched no fused op"
    for mode in ("off", "on"):
        out, got_calls, hub = runs[mode]
        assert got_calls == calls, mode
        for k, t in base["state"].params.items():
            assert torch.equal(out["state"].params[k], t), (mode, k)
        for k in ("train_loss", "consensus", "test_acc"):
            assert out[k] == base[k], (mode, k)
        if scen is not None:
            for k in STREAM_FIELDS:
                np.testing.assert_array_equal(out["streams"][k], base["streams"][k], err_msg=k)
                steps_k, vals = hub.series(k)
                assert steps_k.tolist() == list(range(steps // TAU)), (mode, k)
                np.testing.assert_array_equal(vals, out["streams"][k].astype(np.float64))
        assert hub.series("eval/train_loss")[1].tolist() == [base["train_loss"]]

    rounds = steps // TAU
    labels = {"local", "gossip", "eval"} | ({"metrics"} if scen is not None else set())
    assert set(spanned.labels("span_seconds")) == labels
    assert len(spanned.series("span_seconds", "gossip")[0]) == rounds
    assert len(spanned.series("span_seconds", "local")[0]) == rounds + 1   # and the tail
    assert runs["off"][2].labels("span_seconds") == ()
    params = {k: v.unsqueeze(0).repeat((N,) + (1,) * v.dim())
              for k, v in tproblem.mlp_init(0).items()}
    per_round = link_bytes_per_round(tproblem.make_algorithm("dse_mvr", 0.3, TAU, steps,
                                                             **kw).comm, params)
    for mode in ("off", "on"):
        hub = runs[mode][2]
        assert {lb: hub.total("link_bytes", lb) for lb in hub.labels("link_bytes")} == {
            lb: b * rounds for lb, b in per_round.items()}, mode
        assert hub.labels("kernel_launches") == ()   # nothing launches on the CPU


@pytest.mark.parametrize("spans", [False, True])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_link_bytes_and_streams_match_reference(case, spans):
    """The port's hub against the reference Simulator's over the same run:
    the link-byte series (steps and values) equal, the stream series in the
    main-path band, the same span phases."""
    kw = dict(_CASES[case])
    scen = kw.pop("scenario", None)
    steps = 16
    want = _reference_hub(steps, spans, scenario=scen, **kw)
    got = ttel.Telemetry(spans=spans)
    _port_run(steps, got, scenario=None if scen is None else make_scenario(scen), **kw)
    assert got.labels("link_bytes") == want.labels("link_bytes")
    for lb in want.labels("link_bytes"):
        for a, b in zip(got.series("link_bytes", lb), want.series("link_bytes", lb)):
            np.testing.assert_array_equal(a, b)
        assert got.total("link_bytes", lb) == want.total("link_bytes", lb)
    assert got.labels("span_seconds") == want.labels("span_seconds")
    assert set(got.streams) == set(want.streams)
    if scen is not None:
        for k in STREAM_FIELDS:
            (gs, gv), (ws, wv) = got.series(k), want.series(k)
            np.testing.assert_array_equal(gs, ws)
            np.testing.assert_allclose(gv, wv, rtol=RUN_RTOL, atol=RUN_ATOL, err_msg=k)


def test_run_rounds_hook_records_per_round():
    """The external ``run_rounds`` hook: spans number the rounds across
    calls, and the state is the telemetry-free hook's bit for bit."""
    data, _ = tproblem.make_paper_problem(OMEGA, seed=SEED)
    alg = tproblem.make_algorithm("dse_mvr", 0.3, TAU, 24, channel="choco",
                                  compression="top_k:0.1")
    states = {}
    for spans in (None, False, True):
        hub = None if spans is None else ttel.Telemetry(spans=spans)
        sim = Simulator(alg, ring(N), tproblem.mlp_loss, data, B, telemetry=hub, device="cpu")
        state = sim.init_state(tproblem.mlp_init(0))
        state = sim.run_rounds(sim.run_rounds(state, 2), 1)
        states[spans] = (state, hub)
    for spans in (False, True):
        for k, t in states[None][0].params.items():
            assert torch.equal(states[spans][0].params[k], t), (spans, k)
    off, on = states[False][1], states[True][1]
    assert off.series("link_bytes", "params/choco_top_k0.1")[0].tolist() == [-1, -1]
    assert on.series("span_seconds", "gossip")[0].tolist() == [0, 1, 2]
    assert on.series("link_bytes", "params/choco_top_k0.1")[0].tolist() == [0, 1, 2]
    assert (on.total("link_bytes", "y/choco_top_k0.1")
            == off.total("link_bytes", "y/choco_top_k0.1"))


# ----------------------------------------------------------- serving plane
def _publish_infos():
    rng = np.random.default_rng(1)
    for p in range(6):
        age = rng.integers(0, 4, 3)
        yield {"age": age, "sent": age == 0, "bytes": rng.integers(100, 1000, 3)}


def test_serving_metrics_match_reference():
    got, want = ServingMetrics((2, 3, 4)), JServingMetrics((2, 3, 4))
    for info in _publish_infos():
        got.record_publish(info)
        want.record_publish(info)
    for m in (got, want):
        m.record_requests(8, 128, 2.0)
        m.record_requests(3, 30, 0.0)
    g, w = got.streams(), want.streams()
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    np.testing.assert_array_equal(got.max_age(), want.max_age())
    assert got.slo_report() == want.slo_report() and got.summary() == want.summary()
    assert _masked_prometheus(got.prometheus()) == _masked_prometheus(want.prometheus())
    assert "repro_serving_requests_per_sec 3e+09" in got.prometheus()
    empty = ServingMetrics((5,))
    assert empty.max_age().tolist() == [0] and empty.slo_ok()


def test_request_driver_with_a_hub_keeps_its_tokens():
    cfg = get_reduced("gemma2_2b")
    model = Model(cfg)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(0)
    work = [(rng.integers(0, cfg.vocab_size, rng.integers(3, 7)).tolist(), 4) for _ in range(5)]
    want = RequestDriver(model, slots=3, max_len=16, device="cpu").run(params, work)
    hub = ttel.Telemetry(meta={})
    metrics = ServingMetrics((1,), telemetry=hub)
    driver = RequestDriver(model, slots=3, max_len=16, device="cpu", telemetry=hub,
                           metrics=metrics)
    got = driver.run(params, work)
    assert got["steps"] == want["steps"]
    for i in want["outputs"]:
        np.testing.assert_array_equal(got["outputs"][i], want["outputs"][i])
    assert hub.labels("span_seconds") == ("serve/admit", "serve/decode")
    for phase in ("serve/admit", "serve/decode"):
        assert hub.series("span_seconds", phase)[0].tolist() == list(range(got["steps"]))
    assert metrics.streams()["requests_per_sec"].tolist() == [got["requests_per_sec"]]
    assert "repro_serving_requests_per_sec " in metrics.prometheus()
    # the metrics' hub serves the spans when no hub is given
    only = RequestDriver(model, slots=3, max_len=16, device="cpu",
                         metrics=ServingMetrics((1,), telemetry=ttel.Telemetry(meta={})))
    assert only.telemetry is only.metrics.telemetry
