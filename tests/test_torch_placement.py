"""The port's elastic placement plane held to the JAX package:
``PlacementController``, ``LoadForecaster`` and ``FleetBusExecutor``'s
placement plane.

The controller's policy is copied from the reference, so every policy case
of ``tests/test_placement.py`` feeds identical signals to the reference's
controller and the port's and holds their decisions, events and
statistics equal, then checks the case's own claim on the port.  The
``LoadForecaster`` fits the port's LSTM, so its forecasts are held to the
reference's through the reference's draws (the fixture's ``ramp`` and
``elastic_spike`` fits, ``tests/data/torch_parity_requests.npz``, written
by ``tests/test_torch_query_plane.py``).  The ``elastic_spike`` run is
replayed end to end (``chip_smoke.run_request_replay``), then the plane's
properties: calm elastic equal to static, byte-identical reruns, depth
sampling and restored workers, and the launcher's ``--qps --elastic``.
"""
import importlib.util
import json
import types
from pathlib import Path

import pytest
import torch

from repro.runtime import LatencyLedger as RefLatencyLedger
from repro.runtime import LoadForecaster as RefLoadForecaster
from repro.runtime import PlacementController as RefPlacementController
from repro.runtime import SiteSignal as RefSiteSignal
from repro.runtime import StreamSignal as RefStreamSignal
from repro_torch.launch import edge_cloud
from repro_torch.runtime import (
    LatencyLedger,
    LoadForecaster,
    PlacementController,
    SiteSignal,
    StreamSignal,
)
from repro_torch.training.optimizer import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

REF = types.SimpleNamespace(ctl=RefPlacementController, site=RefSiteSignal,
                            stream=RefStreamSignal)
PORT = types.SimpleNamespace(ctl=PlacementController, site=SiteSignal,
                             stream=StreamSignal)


def sigs(api, edge_backlog=0.0, cloud_backlog=0.0, edge_workers=1,
         cloud_workers=4):
    return [api.site("edge", "edge", edge_workers, 1, edge_backlog),
            api.site("cloud", "cloud", cloud_workers, 4, cloud_backlog)]


def reactive(api, **kw):
    kw.setdefault("proactive", False)
    return api.ctl(**kw)


# each case drives a controller of ``api`` and returns (controller, the
# decisions it made); the case's check then holds the port's to the claim
# of tests/test_placement.py


def drifting(api):
    ctl = reactive(api, persistence=2, min_residency=0)
    s = api.stream("t00", "edge", drift_hot=1.0, queue_s=0.0)
    return ctl, [ctl.step(float(k), sigs(api), [s]) for k in range(2)]


def queued(api):
    ctl = reactive(api, persistence=2, min_residency=0, migrate_up_s=0.5)
    s = api.stream("t00", "edge", drift_hot=0.0, queue_s=3.0)
    out = []
    for k in range(4):
        out.append(ctl.step(float(k), sigs(api, edge_backlog=3.0), [s]))
        if out[-1].migrations:
            break
    return ctl, out


def cold(api):
    ctl = reactive(api, persistence=2, min_residency=0)
    s = api.stream("t00", "cloud", drift_hot=0.0, queue_s=0.0)
    return ctl, [ctl.step(float(k), sigs(api), [s]) for k in range(2)]


def cold_busy_edge(api):
    ctl = reactive(api, persistence=2, min_residency=0)
    s = api.stream("t00", "cloud", drift_hot=0.0, queue_s=0.0)
    return ctl, [ctl.step(float(k), sigs(api, edge_backlog=5.0), [s])
                 for k in range(5)]


def residency(api):
    ctl = reactive(api, persistence=1, min_residency=3)
    out = [ctl.step(0.0, sigs(api),
                    [api.stream("t00", "edge", drift_hot=1.0, queue_s=0.0)])]
    for k in range(1, 6):
        out.append(ctl.step(float(k), sigs(api), [
            api.stream("t00", "cloud", drift_hot=0.0, queue_s=0.0)]))
        if out[-1].migrations:
            break
    return ctl, out


def capped(api):
    ctl = reactive(api, persistence=1, min_residency=0,
                   max_migrations_per_tick=2)
    streams = [api.stream(f"t{i:02d}", "edge", 1.0, 0.0) for i in range(5)]
    return ctl, [ctl.step(0.0, sigs(api), streams)]


def _scaled(api, ctl, ticks, load, workers=1):
    out = []
    for k in ticks:
        d = ctl.step(float(k), sigs(api, edge_backlog=load(workers),
                                    edge_workers=workers), [])
        workers = d.workers.get("edge", workers)
        out.append(d)
    return workers, out


def up_then_down(api):
    ctl = reactive(api, persistence=2, cooldown=0, max_workers=3)
    workers, a = _scaled(api, ctl, range(6), lambda w: 4.0 * w)
    _, b = _scaled(api, ctl, range(6, 16), lambda w: 0.0, workers)
    return ctl, a + b


def oscillating(api):
    ctl = reactive(api, persistence=2, cooldown=2)
    return ctl, [ctl.step(float(k), sigs(api, edge_backlog=(
        0.8 if k % 2 == 0 else 0.0)), []) for k in range(20)]


def dead_band(api):
    ctl = reactive(api, scale_up_s=0.5, scale_down_s=0.05, persistence=1,
                   cooldown=0)
    return ctl, [ctl.step(float(k), sigs(api, edge_backlog=0.2), [])
                 for k in range(10)]


def cooldown(api):
    ctl = reactive(api, persistence=1, cooldown=3, max_workers=8)
    _, out = _scaled(api, ctl, range(9), lambda w: 10.0 * w)
    return ctl, out


def _final_workers(decisions, start=1):
    w = start
    for d in decisions:
        w = d.workers.get("edge", w)
    return w


CHECKS = {
    "drifting": lambda ctl, d: (
        d[0].migrations == {} and d[1].migrations == {"t00": "cloud"}
        and ctl.events[-1]["reason"] == "hot"),
    "queued": lambda ctl, d: d[-1].migrations == {"t00": "cloud"},
    "cold": lambda ctl, d: (d[0].migrations == {}
                            and d[1].migrations == {"t00": "edge"}),
    "cold_busy_edge": lambda ctl, d: all(x.migrations == {} for x in d),
    "residency": lambda ctl, d: (d[0].migrations == {"t00": "cloud"}
                                 and d[-1].migrations and len(d) - 1 >= 3),
    "capped": lambda ctl, d: len(d[0].migrations) == 2,
    "up_then_down": lambda ctl, d: (
        _final_workers(d[:6]) == 3 and _final_workers(d) == 1
        and ctl.stats()["scale_events"] >= 4
        and ctl.stats()["proactive_scale_events"] == 0),
    "oscillating": lambda ctl, d: (all(x.workers == {} for x in d)
                                   and ctl.stats()["scale_events"] == 0),
    "dead_band": lambda ctl, d: all(x.empty() for x in d),
    "cooldown": lambda ctl, d: _spaced([k for k, x in enumerate(d)
                                        if x.workers]),
}


def _spaced(ticks):
    return len(ticks) >= 2 and all(b - a >= 3
                                   for a, b in zip(ticks, ticks[1:]))


CASES = {"drifting": drifting, "queued": queued, "cold": cold,
         "cold_busy_edge": cold_busy_edge, "residency": residency,
         "capped": capped, "up_then_down": up_then_down,
         "oscillating": oscillating, "dead_band": dead_band,
         "cooldown": cooldown}


def _decisions(ds):
    return [(d.t, d.workers, d.migrations, d.notes) for d in ds]


@pytest.mark.parametrize("case", list(CASES))
def test_policy_decisions_equal_reference(case):
    """Identical signals give the reference's and the port's controllers
    equal decisions, events and statistics, and the port's meet the
    case's claim."""
    ref_ctl, ref_d = CASES[case](REF)
    ctl, d = CASES[case](PORT)
    assert _decisions(d) == _decisions(ref_d)
    assert ctl.events == ref_ctl.events
    assert ctl.stats() == ref_ctl.stats()
    assert CHECKS[case](ctl, d), _decisions(d)


def test_inverted_hysteresis_thresholds_raise():
    for cls in (PlacementController, RefPlacementController):
        with pytest.raises(ValueError):
            cls(scale_up_s=0.1, scale_down_s=0.2, proactive=False)
        with pytest.raises(ValueError):
            cls(migrate_up_s=0.05, migrate_down_s=0.05, proactive=False)


def test_ledger_depth_sampling_and_ewma():
    for led in (LatencyLedger(), RefLatencyLedger()):
        assert led.depth_series("edge") == []
        led.sample_depth("edge", 0.0, 1.0)
        led.sample_depth("edge", 1.0, 3.0)
        assert led.depth_series("edge") == [(0.0, 1.0), (1.0, 3.0)]
        assert led.depth_ewma("edge", 0.3) == pytest.approx(
            0.7 * 0.3 * 1.0 + 0.3 * 3.0)
        assert "edge" not in led.table()


# ---------------------------------------------------------------------------
# the LoadForecaster
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fx():
    return smoke.load_fixture(smoke.REQUEST_FIXTURE)


@pytest.fixture(scope="module")
def single_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_load_forecaster_without_a_fit_equals_reference():
    """A short history falls back to the last sample and an idle one to
    the trend, with no fit, as the reference's."""
    ours, ref = LoadForecaster(device="cpu"), RefLoadForecaster()
    for series in ([0.1, 0.2], [], [0.0] * 8, [0.3] * 5):
        assert ours.forecast(series) == ref.forecast(series)
    assert ours.forecast([0.0] * 8) <= 1e-6
    assert ours.fits == 0 and ours._fc is None


def test_load_forecaster_sees_ramp_coming(single_thread):
    """With its own draws, a linear ramp forecasts above its last point;
    one fit a forecast."""
    fc = LoadForecaster(horizon=2, epochs=4, device="cpu")
    ramp = [0.05 * k for k in range(8)]
    assert fc.forecast(ramp) > ramp[-1]
    assert fc.fits == 1


def test_ramp_replay_matches_reference(fx, single_thread):
    """tests/test_placement.py's scale-ahead ramp with the reference's
    forecaster draws: every forecast within 1e-5 of the reference's, the
    same decisions and events, one proactive scale before the reactive
    threshold."""
    decisions, ctl, log = smoke.run_ramp_replay(fx, "cpu")
    assert json.loads(json.dumps(decisions)) == json.loads(
        str(fx["ramp/decisions"]))
    assert smoke.check_forecasts(fx, "ramp", log, smoke.FORECAST_RTOL) <= \
        smoke.FORECAST_RTOL
    smoke._events_equal(ctl.events, json.loads(str(fx["ramp/events"])),
                        smoke.FORECAST_RTOL)
    s = ctl.stats()
    assert s["proactive_scale_events"] == 1 and s["forecaster_fits"] >= 1
    ev = [e for e in ctl.events if e["event"] == "scale"][0]
    assert ev["trigger"] == "proactive-up" and ev["ewma"] < 0.5


# ---------------------------------------------------------------------------
# the elastic plane on the bus
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def spike(fx, single_thread):
    return smoke.run_request_replay(fx, "cpu", "elastic_spike")


def test_elastic_spike_replay_matches_reference(fx, spike):
    """The reference's spike run from its draws: answers within 1e-5;
    stamps, statistics, migrations (time, stream, sites, state bytes),
    scale events and final workers exactly; its forecasts within 1e-5;
    every post-warm-up window of every stream scored, one fleet fit and
    one predict a kind a window across the migrations."""
    res, ex, _, log = spike
    worst = smoke.check_request_run(fx, "elastic_spike", res, ex,
                                    smoke.REQUEST_ATOL)
    assert worst["answer"] <= smoke.REQUEST_ATOL
    smoke.check_forecasts(fx, "elastic_spike", log, smoke.FORECAST_RTOL)
    p = res.placement
    assert len(p["migrations"]) >= 1
    assert all(m["to"] == "cloud" and m["state_nbytes"] > 0
               for m in p["migrations"])
    assert p["controller"]["proactive_scale_events"] >= 1
    for sid, r in res.results.items():
        assert [rec.window for rec in r.records] == [1, 2, 3], sid
    assert res.train_dispatches == 4
    for kind in ("batch", "speed"):
        d = res.infer_dispatches[kind]
        assert d["ticks"] == d["dispatches"] == 3
    assert "placement_migration" in res.ledger.table()


def test_elastic_samples_depth_and_restores_workers(spike):
    res, ex, _, _ = spike
    edge = res.ledger.depth_series("edge")
    assert edge and [t for t, _ in edge] == sorted(t for t, _ in edge)
    assert res.placement["base_workers"] == {"edge": 1, "cloud": 4}
    assert res.placement["final_workers"]["edge"] > 1
    assert ex.topo.sites["edge"].workers == 1


def test_elastic_runs_are_byte_identical(fx, spike):
    """A rerun of the spike (a fresh controller and forecaster) gives the
    same ledger, depth series, forecasts, migrations, sites and final
    params, byte for byte."""
    r1, _, _, log1 = spike
    r2, _, _, log2 = smoke.run_request_replay(fx, "cpu", "elastic_spike")
    assert r1.ledger.table() == r2.ledger.table()
    for site in ("edge", "cloud"):
        assert r1.ledger.depth_series(site) == r2.ledger.depth_series(site)
    assert [c[1] for c in log1["calls"]] == [c[1] for c in log2["calls"]]
    assert r1.placement["migrations"] == r2.placement["migrations"]
    assert r1.placement["stream_site"] == r2.placement["stream_site"]
    for sid in r1.final_params:
        l1 = tree_leaves(r1.final_params[sid])
        l2 = tree_leaves(r2.final_params[sid])
        assert len(l1) == len(l2)
        for a, b in zip(l1, l2):
            assert a.numpy().tobytes() == b.numpy().tobytes()


def test_calm_elastic_matches_static(fx, single_thread):
    """Calm load: the default (proactive) controller observes every tick
    but never acts, so records and answers equal static placement's
    exactly, and the one-predict-a-window path is unchanged."""
    static, _, _, _ = smoke.run_request_replay(fx, "cpu", "serve_float")
    calm, _, _, _ = smoke.run_request_replay(fx, "cpu", "serve_float",
                                             elastic=True)
    assert calm.placement is not None
    assert calm.placement["migrations"] == []
    assert calm.placement["controller"]["scale_events"] == 0
    assert calm.placement["controller"]["ticks"] > 0
    for sid in static.results:
        assert smoke.records_array(static.results[sid].records).tolist() \
            == smoke.records_array(calm.results[sid].records).tolist()
    assert [q.answer for q in static.queries] == \
        [q.answer for q in calm.queries]
    assert calm.infer_dispatches == static.infer_dispatches


@pytest.mark.parametrize("flags", [[], ["--quantized"]])
def test_fleet_launcher_qps_elastic_on_cpu(flags, capsys, single_thread):
    """``--real --streams 2 --qps --slots --elastic`` on the CPU: every
    request answered at one predict a tick, every post-warm-up window
    scored, and the request plane's and placement lines printed."""
    args = edge_cloud.parse_args(
        ["--real", "--streams", "2", "--windows", "2", "--fast",
         "--deployment", "integrated", "--period", "5", "--qps", "2",
         "--slots", "2", "--elastic", *flags])
    assert (args.qps, args.slots, args.elastic) == (2.0, 2, "proactive")
    res = edge_cloud.run_real_fleet(args, device="cpu")[
        "edge-cloud-integrated"]
    s = res.serving
    assert s["n_answered"] == s["n_requests"] == 10 and s["n_starved"] == 0
    assert s["dispatches_per_tick"] == 1.0
    assert all(len(r.records) == 1 for r in res.results.values())
    out = capsys.readouterr().out
    assert "request plane: 10/10 answered (0 starved)" in out
    assert "elastic (proactive, interval 2.5s)" in out
    assert "final placement: t00@edge t01@edge" in out


def test_launcher_elastic_choices(capsys):
    args = edge_cloud.parse_args(["--real", "--streams", "3", "--elastic",
                                  "reactive"])
    assert args.elastic == "reactive" and args.qps == 0.0
    with pytest.raises(SystemExit):
        edge_cloud.parse_args(["--real", "--streams", "3", "--elastic",
                               "sideways"])
    assert "invalid choice" in capsys.readouterr().err
