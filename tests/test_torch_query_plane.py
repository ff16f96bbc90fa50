"""The port's request plane held to the JAX package: ``QueryPlane``, the
open-loop trace, the batched serving tick and ``FleetBusExecutor``'s
request plane.

The counterparts of ``tests/test_query_plane.py`` run on the port, each fed
what the reference's test feeds its own.  Then the reference's request and
placement runs (``smoke.REQUEST_RUNS``) on the fleet fixture's fleet
(``tests/data/torch_parity_fleet.npz``: 3 streams x 4 windows x 150
records) in the integrated deployment, at a 5 s window period under the
reference's fixed stage costs, are replayed through the port from the
reference's draws (``chip_smoke.run_request_replay``, the code the card
runs): every answer to 1e-5, every stamp, latency and statistic exactly.

``python tests/test_torch_query_plane.py`` writes the card's copy of the
reference's runs, ``tests/data/torch_parity_requests.npz``.
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core import FleetStages as RefFleetStages
from repro.core import lstm_fleet_forecaster as ref_fleet_forecaster
from repro.core.scenarios import CHAOS_STAGE_COSTS
from repro.runtime import CostModel as RefCostModel
from repro.runtime import FleetBusExecutor as RefFleetBusExecutor
from repro.runtime import LoadForecaster as RefLoadForecaster
from repro.runtime import PlacementController as RefPlacementController
from repro.runtime import SiteSignal as RefSiteSignal
from repro.runtime import edge_cloud_integrated as ref_integrated
from repro.runtime import paper_topology as ref_topology
from repro.serving.query_plane import ForecastQuery as RefForecastQuery
from repro.serving.query_plane import QueryPlane as RefQueryPlane
from repro.serving.query_plane import latency_stats as ref_latency_stats
from repro.serving.query_plane import open_loop_trace as ref_open_loop_trace
from repro.streams.sources import fleet_windowed_streams as ref_fleet_streams
from repro.training.compiled import bucket_examples as ref_bucket_examples
from repro_torch.configs import get_config
from repro_torch.core import FleetStages, lstm_fleet_forecaster
from repro_torch.runtime import (
    CostModel,
    FleetBusExecutor,
    edge_cloud_integrated,
    paper_topology,
)
from repro_torch.runtime.modules import T_RESPONSE, stream_topic
from repro_torch.serving import (
    ForecastQuery,
    QueryPlane,
    latency_stats,
    open_loop_trace,
)
from repro_torch.serving.batching import BatchScheduler, Request
from repro_torch.serving.quantize import quantize_fleet
from repro_torch.streams.sources import fleet_windowed_streams

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

# the fixture's runs: the trace of tests/test_query_plane.py's bus run (12
# qps, 30 requests from 5 s, seed 3) on 4 slots at a 5 s period, and
# benchmarks/bench_elastic.py's spike (serving and inference walls raised)
# under its proactive controller at the same rate
RSETUP = {"period": 5.0, "qps": 12.0, "n_requests": 30, "start": 5.0,
          "trace_seed": 3, "slots": 4, "ingest_s": smoke.BUS_INGEST_S}
SPIKE_OVERRIDES = {"serving": 0.2, "speed_inference": 0.4,
                   "batch_inference": 0.4}
SPIKE_CONTROLLER = {"proactive": True, "migrate_up_s": 0.8,
                    "migrate_down_s": 0.05, "scale_up_s": 1.5,
                    "scale_down_s": 0.05, "persistence": 1, "cooldown": 2,
                    "max_workers": 3, "min_residency": 2}
SPIKE_FORECASTER = {"lag": 4, "hidden": 8, "epochs": 6, "history": 16,
                    "horizon": 3, "seed": 0}
# tests/test_placement.py's scale-ahead controller, fed smoke.RAMP_LOADS
RAMP_CONTROLLER = {"proactive": True, "persistence": 2, "cooldown": 0,
                   "scale_up_s": 0.5, "max_workers": 2}
RAMP_FORECASTER = {"lag": 4, "hidden": 8, "epochs": 4, "history": 16,
                   "horizon": 3, "seed": 0}


def _flatten(prefix, tree, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(f"{prefix}/{k}", v, out)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)


def reference_load_draws(fc, data, key):
    """The init params and ``(epochs*steps, batch)`` permutation indices the
    reference's ``CompiledForecaster.train`` draws from ``key`` for
    ``data`` (its ``train`` splits the key, inits from the first half and
    permutes each epoch from the second); the indices as int16."""
    eng = fc.engine
    nb = ref_bucket_examples(len(data["x"]), eng.batch_size)
    init_key, perm_key = jax.random.split(key)
    init = jax.tree_util.tree_map(np.asarray, eng._init_fn(init_key))
    perms = jax.vmap(lambda k: jax.random.permutation(k, nb))(
        jax.random.split(perm_key, eng.epochs))
    return init, np.asarray(perms).reshape(-1, eng.batch_size).astype(
        np.int16)


def recording_load_forecaster(lf):
    """Record every fit's draws, every forecast (series, value, fitted?)
    and every fitted LSTM's prediction of the reference's
    ``LoadForecaster`` ``lf``."""
    fc = lf._forecaster()
    log = {"calls": [], "fits": [], "preds": []}

    def train(data, params, key):
        log["fits"].append(reference_load_draws(fc, data, key))
        return fc.train(data, params, key)

    def predict(params, x):
        y = fc.predict(params, x)
        log["preds"].append(float(np.asarray(y).reshape(-1)[0]))
        return y

    lf._fc = dataclasses.replace(fc, train=train, predict=predict)
    forecast = lf.forecast

    def logged(series):
        n0 = len(log["fits"])
        value = forecast(series)
        log["calls"].append((np.asarray(series, np.float64), value,
                             len(log["fits"]) > n0))
        return value

    lf.forecast = logged
    return log


def store_load_log(out, run, cfg, log):
    for k, v in cfg.items():
        out[f"lfcfg/{run}/{k}"] = np.asarray(v)
    out[f"lf/{run}/n_fits"] = np.asarray(len(log["fits"]))
    for k, (init, idx) in enumerate(log["fits"]):
        _flatten(f"lf/{run}/init{k}", init, out)
        out[f"lf/{run}/idx{k}"] = idx
    out[f"lf/{run}/value"] = np.array([v for _, v, _ in log["calls"]],
                                      np.float64)
    out[f"lf/{run}/fitted"] = np.array([f for _, _, f in log["calls"]])
    out[f"lf/{run}/pred"] = np.array(log["preds"], np.float64)
    for i, (series, _, _) in enumerate(log["calls"]):
        out[f"lf/{run}/series{i}"] = series


def reference_ramp(out):
    """tests/test_placement.py's scale-ahead ramp on the reference: its
    decisions, events and forecaster fits."""
    lf = RefLoadForecaster(**{k: v for k, v in RAMP_FORECASTER.items()})
    log = recording_load_forecaster(lf)
    ctl = RefPlacementController(forecaster=lf, **RAMP_CONTROLLER)
    decisions = []
    for k, load in enumerate(smoke.RAMP_LOADS):
        d = ctl.step(float(k), [RefSiteSignal("edge", "edge", 1, 1, load),
                                RefSiteSignal("cloud", "cloud", 4, 4, 0.0)],
                     [])
        decisions.append((d.workers, d.migrations))
        if d.workers:
            break
    for k, v in RAMP_CONTROLLER.items():
        out[f"ctl/ramp/{k}"] = np.asarray(v)
    out["ramp/decisions"] = np.asarray(json.dumps(decisions))
    out["ramp/events"] = np.asarray(json.dumps(ctl.events))
    store_load_log(out, "ramp", RAMP_FORECASTER, log)


def build_fixture():
    """Run the reference's ``smoke.REQUEST_RUNS`` on the fleet fixture's
    fleet and batch model and return the arrays: the setup, the stage costs
    and controller settings, each run's queries (``q/{run}/{column}``), its
    serving statistics, dispatch counts and placement (JSON), its records,
    and every ``LoadForecaster`` fit's draws with the forecasts; then the
    scale-ahead ramp's."""
    fleet_fx = smoke.load_fixture(smoke.FLEET_FIXTURE)
    fs = smoke.unflatten(fleet_fx, "fsetup")
    streams, _ = ref_fleet_streams(
        int(fs["n_streams"]), int(fs["n_windows"]),
        int(fs["records_per_window"]), [str(x) for x in fs["scenarios"]],
        seed=int(fs["seed"]), hist_len=int(fs["hist_len"]),
        alphas=np.full(5, float(fs["drift_alpha"])))
    ids = list(streams)
    bp = jax.tree_util.tree_map(jnp.asarray,
                                smoke.unflatten(fleet_fx, "batch"))
    serve_costs = dict(CHAOS_STAGE_COSTS)
    spike_costs = {**serve_costs, **SPIKE_OVERRIDES}
    out = {f"rsetup/{k}": np.asarray(v) for k, v in RSETUP.items()}
    for name, costs in (("serve", serve_costs), ("spike", spike_costs)):
        for k, v in costs.items():
            out[f"costs/{name}/{k}"] = np.asarray(v)
    for k, v in SPIKE_CONTROLLER.items():
        out[f"ctl/elastic_spike/{k}"] = np.asarray(v)
    s = RSETUP
    # one fleet forecaster for every run: its fits depend on the data and
    # keys alone, and its compiled executables are built once
    ff = ref_fleet_forecaster(ref_config("lstm-paper"),
                              epochs=int(fs["speed_epochs"]),
                              batch_size=int(fs["speed_batch_size"]))
    for name, (quantized, elastic) in smoke.REQUEST_RUNS.items():
        logs = []
        kw = {}
        if elastic:
            def factory():
                lf = RefLoadForecaster(**SPIKE_FORECASTER)
                logs.append(recording_load_forecaster(lf))
                return RefPlacementController(forecaster=lf,
                                              **SPIKE_CONTROLLER)

            kw = dict(qps=s["qps"], elastic=True, controller_factory=factory,
                      stage_costs=spike_costs)
        else:
            kw = dict(query_trace=ref_open_loop_trace(
                ids, s["qps"], s["n_requests"], start=s["start"],
                seed=s["trace_seed"]), stage_costs=serve_costs)
        ex = RefFleetBusExecutor(
            RefFleetStages.build(ff, mode="dynamic"), ref_integrated(),
            ref_topology(), RefCostModel(ingest_s=s["ingest_s"]),
            window_period_s=s["period"], serve_slots=s["slots"],
            quantized_sync=quantized, **kw)
        res = ex.run(streams, bp, jax.random.PRNGKey(int(fs["run_key"])))
        for c, v in smoke.query_columns(res.queries, ex._query_lat).items():
            out[f"q/{name}/{c}"] = v
        out[f"serving/{name}"] = np.asarray(json.dumps(res.serving))
        out[f"dispatch/{name}"] = np.asarray(json.dumps(
            {"train": res.train_dispatches, "infer": res.infer_dispatches}))
        for sid in ids:
            out[f"records/{name}/{sid}"] = smoke.records_array(
                res.results[sid].records)
        if elastic:
            out[f"placement/{name}"] = np.asarray(json.dumps(res.placement))
            store_load_log(out, name, SPIKE_FORECASTER, logs[-1])
    reference_ramp(out)
    return out


@pytest.fixture(scope="module")
def fx():
    return smoke.load_fixture(smoke.REQUEST_FIXTURE)


@pytest.fixture(scope="module")
def single_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def replays(fx, single_thread):
    """The port's serving runs from the reference's draws, on the CPU."""
    return {name: smoke.run_request_replay(fx, "cpu", name)
            for name, (_, elastic) in smoke.REQUEST_RUNS.items()
            if not elastic}


# ---------------------------------------------------------------------------
# the scheduler and the query plane, as tests/test_query_plane.py holds them
# ---------------------------------------------------------------------------


def _req(uid, n_new=1):
    return Request(uid=uid, prompt=np.arange(3, dtype=np.int32),
                   max_new_tokens=n_new)


def test_scheduler_slot_recycling_staggered_arrivals():
    """Slots freed by short requests refill from the queue in FIFO order
    without waiting for the long co-batched request; the clock stamps
    admission and finish."""
    s = BatchScheduler(2)
    long_req = _req(0, n_new=5)
    s.submit(long_req)
    s.submit(_req(1, n_new=1))
    assert s.admit(now=0.0) == [0, 1]
    assert long_req.admitted_at == 0.0
    s.submit(_req(2, n_new=1))
    assert s.admit(now=1.0) == []
    s.slots[1].request.generated.append(7)
    done = s.retire_finished(now=2.0)
    assert [r.uid for r in done] == [1] and done[0].finished_at == 2.0
    assert s.admit(now=3.0) == [1]
    assert s.slots[1].request.uid == 2
    assert s.slots[1].request.admitted_at == 3.0
    assert s.slots[0].request is long_req
    assert not s.idle


def _drain(plane, ids, pred=0.5):
    ticks = 0
    while plane.busy:
        plane.admit(float(ticks))
        by_stream, xs = plane.build_batch()
        plane.apply(by_stream, [np.full((len(x), 1), pred) for x in xs],
                    {sid: 0 for sid in ids})
        plane.retire(float(ticks))
        ticks += 1
        assert ticks < 50, "queue starved"
    return ticks


def test_queryplane_fifo_no_starvation():
    """A queue far longer than the slots drains in FIFO admission order,
    multi-tick horizon queries never pushing later ones out of order; the
    admission and finish stamps equal the reference's plane's."""
    ids = ["a", "b"]
    ctx = np.ones((3, 5, 5), np.float32)
    planes = []
    for plane_cls, query_cls in ((QueryPlane, ForecastQuery),
                                 (RefQueryPlane, RefForecastQuery)):
        plane = plane_cls(ids, n_slots=2)
        for sid in ids:
            plane.observe_window(sid, ctx, 0)
        qs = [query_cls(uid=i, stream=ids[i % 2],
                        kind="horizon" if i % 3 == 0 else "point",
                        horizon=3 if i % 3 == 0 else 1) for i in range(9)]
        for q in qs:
            plane.submit(q)
        planes.append((_drain(plane, ids), qs))
    (ticks, qs), (ref_ticks, ref_qs) = planes
    assert all(q.done and q.finished_at is not None for q in qs)
    admits = [q.admitted_at for q in qs]
    assert admits == sorted(admits)
    assert ticks == ref_ticks
    assert [(q.admitted_at, q.finished_at, q.answer) for q in qs] == \
        [(q.admitted_at, q.finished_at, q.answer) for q in ref_qs]


def test_queryplane_blocks_until_stream_has_context():
    plane = QueryPlane(["a", "b"], n_slots=2)
    x = np.ones((3, 5, 5), np.float32)
    plane.observe_window("b", x, 0)
    plane.submit(ForecastQuery(uid=0, stream="a"))
    plane.submit(ForecastQuery(uid=1, stream="b"))
    assert plane.admit(0.0) == []
    assert plane.context_window("a") == -1
    plane.observe_window("a", x, 0)
    assert plane.admit(1.0) == [0, 1]
    assert plane.context_window("a") == 0


def test_whatif_perturbs_context_once():
    plane = QueryPlane(["a"], n_slots=1)
    plane.observe_window("a", np.full((3, 5, 5), 2.0, np.float32), 0)
    q = ForecastQuery(uid=0, stream="a", kind="whatif",
                      perturb_scale=2.0, perturb_offset=1.0)
    plane.submit(q)
    plane.admit(0.0)
    np.testing.assert_allclose(q.ctx, 2.0 * 2.0 + 1.0)
    by_stream, xs = plane.build_batch()
    plane.apply(by_stream, [np.full((1, 1), 0.25)], {"a": 0})
    assert q.done and q.answer == [0.25]
    with pytest.raises(ValueError, match="unknown query kind"):
        ForecastQuery(uid=1, stream="a", kind="nope")


@pytest.mark.parametrize("seed,qps,n", [(7, 10.0, 40), (3, 12.0, 30),
                                        (0, 0.5, 9)])
def test_open_loop_trace_deterministic_and_equal_to_reference(seed, qps, n):
    ids = ["s0", "s1", "s2"]
    cols = ("uid", "stream", "kind", "horizon", "perturb_scale",
            "perturb_offset", "arrived_at")
    row = lambda q: tuple(getattr(q, c) for c in cols)
    a = open_loop_trace(ids, qps=qps, n_requests=n, start=1.0, seed=seed)
    b = open_loop_trace(ids, qps=qps, n_requests=n, start=1.0, seed=seed)
    ref = ref_open_loop_trace(ids, qps=qps, n_requests=n, start=1.0,
                              seed=seed)
    assert [row(q) for q in a] == [row(q) for q in b] == \
        [row(q) for q in ref]
    other = open_loop_trace(ids, qps=qps, n_requests=n, start=1.0,
                            seed=seed + 1)
    assert [(q.kind, q.perturb_scale) for q in a] != \
        [(q.kind, q.perturb_scale) for q in other]
    assert a[1].arrived_at - a[0].arrived_at == pytest.approx(1.0 / qps)
    assert [q.stream for q in a[:4]] == ["s0", "s1", "s2", "s0"]
    with pytest.raises(ValueError, match="qps"):
        open_loop_trace(ids, qps=0.0, n_requests=1)


def test_latency_stats_empty_is_infinite_and_match_reference():
    s = latency_stats([])
    assert s["p99_s"] == float("inf") and s["p50_s"] == float("inf")
    sample = [0.3, 0.1, 0.25, 2.0, 0.05]
    assert latency_stats(sample) == ref_latency_stats(sample)


# ---------------------------------------------------------------------------
# batched vs unbatched answers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_fleet(single_thread):
    streams, _ = fleet_windowed_streams(3, 2, 60, "gradual", seed=0,
                                        hist_len=400,
                                        alphas=np.full(5, 1.5e-3))
    ff = lstm_fleet_forecaster(get_config("lstm-paper"), epochs=1,
                               batch_size=16, device="cpu")
    ids = list(streams)
    params, _ = ff.train_fleet([streams[sid].supervised(0) for sid in ids],
                               [3, 4, 5])
    return streams, ff, params


@pytest.mark.parametrize("int8", [False, True])
def test_batched_vs_unbatched_answer_parity(small_fleet, int8):
    """Every query kind answered by the batched serving tick equals the
    unbatched per-query answer (a batch-of-one predict a horizon step) to
    1e-6, horizon feedback and same-stream queries sharing a tick
    included, in staggered waves so slots recycle; one stacked predict a
    tick, with float and with int8 serving trees (``smoke.serve_mix``)."""
    streams, ff, params = small_fleet
    if int8:
        params = quantize_fleet(params, min_size=64)
    got = smoke.batched_vs_unbatched(
        ff, params, {sid: streams[sid].supervised(0)["x"]
                     for sid in streams})
    assert got["queries"] == 8
    assert got["dispatches"] == got["ticks"] >= 5
    assert got["worst"] <= smoke.UNBATCHED_ATOL


# ---------------------------------------------------------------------------
# the fixture's runs, replayed from the reference's draws
# ---------------------------------------------------------------------------


def _assert_json_close(a, b, where):
    """Equal JSON trees, floats to 1e-4 relative (a forecast's value comes
    from a fit)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_json_close(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_json_close(x, y, f"{where}/{i}")
    elif isinstance(a, float):
        assert a == pytest.approx(b, rel=1e-4), where
    else:
        assert a == b, where


def test_fixture_regenerates_from_jax(fx):
    """The committed fixture is what the JAX package produces now (stamps,
    statistics and placements exactly; answers, records and draws to
    1e-4: XLA's CPU code may differ in the last bits between machines)."""
    ref = build_fixture()
    assert sorted(ref) == sorted(fx)
    for k, v in ref.items():
        exact = (k.startswith(("rsetup/", "costs/", "ctl/", "lfcfg/",
                               "dispatch/", "ramp/decisions"))
                 or "/idx" in k or k.endswith(("/n_fits", "/fitted"))
                 or (k.startswith("q/") and not k.endswith("/answer")))
        if exact:
            np.testing.assert_array_equal(v, fx[k], err_msg=k)
        elif k.startswith("serving/"):
            assert json.loads(str(v)) == json.loads(str(fx[k])), k
        elif k.startswith(("placement/", "ramp/events")):
            _assert_json_close(json.loads(str(v)), json.loads(str(fx[k])),
                               k)
        elif k.startswith("records/"):
            np.testing.assert_array_equal(v[:, 0], fx[k][:, 0])
            np.testing.assert_allclose(v[:, 1:], fx[k][:, 1:], rtol=1e-4,
                                       atol=1e-7, err_msg=k)
        else:
            np.testing.assert_allclose(v, fx[k], rtol=1e-4, atol=1e-4,
                                       err_msg=k)


@pytest.mark.parametrize("name", ["serve_float", "serve_int8"])
def test_request_replay_matches_reference(fx, replays, name):
    """The port's run from the reference's draws: every answer within 1e-5
    of the reference's; every admission, finish and arrival stamp, latency,
    model and context window and fallback flag, and the serving statistics
    (ticks, dispatches, answered, starved, QPS, percentiles) exactly; each
    stream's records to 1e-5."""
    res, ex, _, _ = replays[name]
    worst = smoke.check_request_run(fx, name, res, ex, smoke.REQUEST_ATOL)
    assert worst["answer"] <= smoke.REQUEST_ATOL
    s = res.serving
    assert s["n_requests"] == s["n_answered"] == 30 and s["n_starved"] == 0
    assert s["dispatches_per_tick"] == 1.0
    assert s["sustained_qps"] >= s["offered_qps"]
    assert np.isfinite(s["p99_s"]) and s["p99_s"] > 0


def test_serving_answers_on_response_topics(replays):
    """Every request is answered on its own stream's response topic, once;
    every answer's model trails its context by at most one window."""
    res, _, _, _ = replays["serve_float"]
    resp = [m.topic for m in res.message_log
            if m.topic.startswith(T_RESPONSE)]
    assert len(resp) == 30
    for q in res.queries:
        assert stream_topic(T_RESPONSE, q.stream) in resp
        assert q.done and q.finished_at is not None
        assert q.admitted_at >= q.arrived_at
        assert 0 <= q.context_window - q.model_window <= 1
        assert not q.served_fallback


def test_unsynced_stream_serves_fallback_stamped(single_thread):
    """On a run path: queries that arrive before their stream's first model
    sync are answered by the batch model, stamped ``served_fallback`` with
    model window -1; later ones by the synced speed model."""
    streams, hist = fleet_windowed_streams(2, 2, 40, "gradual", seed=0,
                                           hist_len=300,
                                           alphas=np.full(5, 1.5e-3))
    ff = lstm_fleet_forecaster(get_config("lstm-paper"), epochs=1,
                               batch_size=16, device="cpu")
    bp, _ = ff.train({"x": hist["x"][:64], "y": hist["y"][:64]}, None, 0)
    ids = list(streams)
    # window 0 reaches the serving site at ~0.01 s; its model syncs after
    # the 0.5 s fit: arrivals from 0.1 s straddle the sync
    trace = open_loop_trace(ids, 4.0, 8, start=0.1, seed=1)
    ex = FleetBusExecutor(
        FleetStages.build(ff, mode="dynamic"), edge_cloud_integrated(),
        paper_topology(), CostModel(ingest_s=0.0), window_period_s=5.0,
        query_trace=trace, serve_slots=2,
        stage_costs=dict(CHAOS_STAGE_COSTS))
    res = ex.run(streams, bp, 1)
    assert res.serving["n_answered"] == 8
    early = [q for q in res.queries if q.served_fallback]
    late = [q for q in res.queries if not q.served_fallback]
    assert early and late
    assert all(q.model_window == -1 for q in early)
    assert all(q.model_window >= 0 for q in late)
    assert res.serving["fallback_frac"] == len(early) / 8


def test_stage_log_records_every_measured_stage(single_thread):
    """``chip_smoke.logging_stages``, which phase 13 (d) runs on the card:
    every stage the executor schedules is logged with its kind, window and
    wall (each serving tick among them), the collector's runs with their
    generation, and ``stage_report`` orders the slowest first; the
    executor's own ``_schedule`` is back afterwards.  Every stage ran with
    the heap frozen (``frozen_heap``), and the heap is thawed after."""
    import gc

    streams, hist = fleet_windowed_streams(2, 2, 40, "gradual", seed=0,
                                           hist_len=300,
                                           alphas=np.full(5, 1.5e-3))
    ff = lstm_fleet_forecaster(get_config("lstm-paper"), epochs=1,
                               batch_size=16, device="cpu")
    bp, _ = ff.train({"x": hist["x"][:64], "y": hist["y"][:64]}, None, 0)
    ex = FleetBusExecutor(
        FleetStages.build(ff, mode="dynamic"), edge_cloud_integrated(),
        paper_topology(), CostModel(ingest_s=0.0), window_period_s=5.0,
        query_trace=open_loop_trace(list(streams), 4.0, 8, start=0.1,
                                    seed=1), serve_slots=2)
    before = gc.get_freeze_count()  # objects the interpreter keeps there
    with smoke.logging_stages(ex, 5.0) as (stages, collections):
        res = ex.run(streams, bp, 1)
        gc.collect()
    assert "_schedule" not in vars(ex)
    # the measured loop ran on a frozen heap, thawed after it
    after = gc.get_freeze_count()
    assert stages[0]["frozen"] > 10 * max(before, after, 100)
    assert all(st["frozen"] is None for st in stages[1:])
    serving = [st for st in stages if st["kind"] == "serving"]
    assert len(serving) == len(res.ledger.comp["serving"]) > 0
    assert {st["window"] for st in stages} == {0, 1}
    assert all(st["wall_s"] >= 0 and st["reserved"] == 0 for st in stages)
    assert any(c["generation"] == 2 for c in collections)
    report = smoke.stage_report(stages, collections, n=3)
    walls = [st["wall_ms"] for st in report["slowest"]]
    assert walls == sorted(walls, reverse=True) and len(walls) == 3
    assert walls[0] == 1e3 * max(st["wall_s"] for st in stages)
    assert report["by_kind"]["serving"]["count"] == len(serving)
    assert report["gc_by_generation"][2]["count"] >= 1
    assert report["frozen_objects"] == stages[0]["frozen"]


if __name__ == "__main__":
    smoke.REQUEST_FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(smoke.REQUEST_FIXTURE, **build_fixture())
    print(f"wrote {smoke.REQUEST_FIXTURE} "
          f"({smoke.REQUEST_FIXTURE.stat().st_size} bytes)")
