"""The port's chaos and health planes held to the JAX package on the fleet
bus: ``FleetBusExecutor`` under a ``FaultPlane`` and a ``HealthPlane``,
``core.scenarios`` and the launcher's ``--chaos``.

The reference runs each of its eight chaos scenarios (and ``fault_free``
once more under static thresholds, ``smoke.CHAOS_RUNS``) on the fleet
fixture's fleet (``tests/data/torch_parity_fleet.npz``: 3 streams x 4
windows x 150 records, 6 speed epochs at batch 64) in the integrated
deployment at a 5 s period, under its fixed stage costs, at 8 qps on 4
slots with staleness bound 1, fault seed 0, with a ``HealthPlane``; and
``tests/test_query_plane.py``'s delayed-sync watchdog run
(``smoke.WATCHDOG_RUN``).  It records each fit's draws by (stream, window,
rows), since record dropout changes a window's rows.  The port replays
every run from those draws (``chip_smoke.run_chaos_replay``, the code the
card runs): the fault schedule, the bus signature, the health verdicts and
adaptations, every stamp, latency and statistic exactly; answers and
records to 1e-5; the envelope's counts exactly and its RMSE to 1e-5
relative.

``tests/test_torch_chaos_fixture.py`` writes the fixture and checks that it
regenerates; ``tests/test_torch_chaos_props.py`` holds the port's own
``ChaosHarness`` to ``tests/test_chaos.py``'s properties.
"""
import argparse
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from repro.core.scenarios import CHAOS_STAGE_COSTS as REF_CHAOS_STAGE_COSTS
from repro.core.scenarios import RMSE_RATIO_MAX as REF_RMSE_RATIO_MAX
from repro.core.scenarios import SCENARIOS as REF_SCENARIOS
from repro.core.scenarios import scenario_plane as ref_scenario_plane
from repro.core.scenarios import scenario_quantized as ref_scenario_quantized
from repro_torch.core import scenarios
from repro_torch.launch import edge_cloud

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


@pytest.fixture(scope="module")
def fx():
    return smoke.load_fixture(smoke.CHAOS_FIXTURE)


@pytest.fixture(scope="module")
def single_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fleet_fx():
    return smoke.load_fixture(smoke.FLEET_FIXTURE)


@pytest.fixture(scope="module")
def replays(fx, fleet_fx, single_thread):
    """Every run of the fixture replayed by the port on the CPU."""
    return {name: smoke.run_chaos_replay(fx, "cpu", name, fleet_fx)
            for name in (*smoke.CHAOS_RUNS, smoke.WATCHDOG_RUN)}


# ---------------------------------------------------------------------------
# the scenario catalogue
# ---------------------------------------------------------------------------


def test_scenario_catalogue_matches_reference():
    """The scenario names, envelopes, stage costs, fault starts and int8
    choices are the reference's; each scenario's fault plane holds the
    reference's specs; an unknown name is refused."""
    assert scenarios.SCENARIOS == REF_SCENARIOS == smoke.CHAOS_SCENARIOS
    assert scenarios.RMSE_RATIO_MAX == REF_RMSE_RATIO_MAX
    assert scenarios.CHAOS_STAGE_COSTS == REF_CHAOS_STAGE_COSTS
    for name in REF_SCENARIOS:
        mine = scenarios.scenario_plane(name, 3, 5.0)
        ref = ref_scenario_plane(name, 3, 5.0)
        assert mine.seed == ref.seed == 3
        for kind in ("message_faults", "site_faults", "partitions",
                     "sensor_faults"):
            assert [vars(f) for f in getattr(mine, kind)] == \
                [vars(f) for f in getattr(ref, kind)], (name, kind)
        assert scenarios.scenario_quantized(name) == \
            ref_scenario_quantized(name)
    assert scenarios.scenario_fault_start("site_crash", 5.0) == 2.02 * 5.0
    assert scenarios.scenario_fault_start("byzantine", 5.0) is None
    with pytest.raises(ValueError, match="pick from"):
        scenarios.scenario_plane("nope", 0, 5.0)


# ---------------------------------------------------------------------------
# the fixture's runs, replayed from the reference's draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [*smoke.CHAOS_RUNS, smoke.WATCHDOG_RUN])
def test_chaos_replay_matches_reference(fx, replays, name):
    """The port's run from the reference's draws: the fault schedule, the
    bus signature (every message's topic, source, bytes and stamps), the
    health verdicts and adaptations, the fits made, every query's stamps,
    latency and statistic exactly; answers and records within 1e-5; the
    envelope's counts exactly and its RMSE to 1e-5 relative."""
    res, ex, fits = replays[name]
    worst = smoke.check_chaos_run(fx, name, res, ex, fits,
                                  smoke.REQUEST_ATOL)
    assert worst["answer"] <= smoke.REQUEST_ATOL
    assert worst["rmse"] <= smoke.CHAOS_RMSE_RTOL


def test_replays_exercise_every_plane(fx):
    """The fixture's runs reach what they exist for: every corrupt and
    forged publish rejected (a forgery by the signature alone), the
    partition suspected within two heartbeat intervals and its heal seen,
    the Byzantine guard flagging, flushes and record dropout under sensor
    chaos, in-flight work lost on the crash, and no verdict or adaptation
    in the calm runs."""
    runs = (*smoke.CHAOS_RUNS, smoke.WATCHDOG_RUN)
    env = {name: json.loads(str(fx[f"env/{name}"])) for name in runs}
    for name in runs:
        assert env[name]["unhandled_exception"] is None
    c = env["corrupted_int8_sync"]
    assert c["corrupt_rejected"] == c["fault_stats"]["msg_corrupt"] > 0
    f = env["forged_sync"]
    assert f["forged_rejected"] == f["fault_stats"]["msg_forge"] > 0
    assert f["corrupt_rejected"] == 0 and f["checksum_verified"] > 0
    p = env["partitioned_sync"]["health"]
    assert p["n_suspected"] >= 1 and p["n_recovered"] >= 1
    assert p["detection_latency_hb_intervals"] <= 2.0
    assert env["byzantine"]["health"]["byz_flagged"] > 0
    s = env["sensor_chaos"]["fault_stats"]
    assert s["agg_flush"] > 0 and s["sensor_record_dropout"] > 0
    assert env["site_crash"]["fault_stats"]["lost_inflight_work"] >= 1
    for name in ("fault_free", "fault_free_static"):
        h = env[name]["health"]
        assert h["n_suspected"] == h["threshold_adaptations"] == 0
        assert h["byz_flagged"] == 0 and h["byz_screened"] > 0
    # record dropout changed rows, so some fit was keyed by fewer rows
    fits = json.loads(str(fx["fits/sensor_chaos"]))
    assert len({n for _, _, n in fits}) > 1


def test_adaptive_calm_replay_byte_identical_to_static(replays):
    """``fault_free`` under adaptive thresholds is byte-identical to the
    same run under static ones: bus log, ledger, forecasts."""
    a, _, _ = replays["fault_free"]
    b, _, _ = replays["fault_free_static"]
    assert scenarios.bus_signature(a) == scenarios.bus_signature(b)
    assert scenarios.ledger_signature(a) == scenarios.ledger_signature(b)
    assert scenarios.forecast_signature(a) == \
        scenarios.forecast_signature(b)


def test_watchdog_serves_fallback_under_delayed_sync(replays):
    """The counterpart of ``tests/test_query_plane.py``'s watchdog test on
    the port: every model sync after window 0 delayed three windows, so
    answers whose speed model fell more than ``staleness_bound`` windows
    behind are served from the batch fallback and stamped so, and every
    answer still served from a speed model honours the bound."""
    res, ex, _ = replays[smoke.WATCHDOG_RUN]
    s = res.serving
    assert s is not None and s["n_answered"] == 30
    assert ex.fault_plane.stats["msg_delay"] > 0
    assert s["fallback_frac"] > 0.0
    assert any(q.served_fallback for q in res.queries)
    for q in res.queries:
        if not q.served_fallback and q.model_window >= 0:
            assert 0 <= q.context_window - q.model_window <= 1
    assert s["max_staleness"] <= 1


def test_reference_cannot_stack_a_float_fallback_beside_int8_models(
        fleet_fx, single_thread):
    """Why the port's int8 speed inference serves an unsynced stream the
    int8 copy of its batch model when other streams serve int8 models: the
    reference's stacked predict over an int8 tree and the float batch tree
    raises (its ``FleetBusExecutor`` hands it exactly that when a stream's
    first model is rejected four times, as in ``forged_sync`` at S = 64),
    while the port's over the two int8 trees serves each stream its own
    tree's answer (to the batched-against-unbatched tolerance)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_config as ref_config
    from repro.core import lstm_fleet_forecaster as ref_fleet_forecaster
    from repro.serving import quantize as ref_quantize
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import lstm_fleet_forecaster
    from repro_torch.serving.quantize import quantize_tree

    bp = smoke.unflatten(fleet_fx, "batch")
    x = np.random.default_rng(0).random((6, 5, 5)).astype(np.float32)
    ref_ff = ref_fleet_forecaster(ref_config("lstm-paper"), epochs=1,
                                  batch_size=16)
    ref_bp = jax.tree_util.tree_map(jnp.asarray, bp)
    with pytest.raises((ValueError, TypeError)):
        ref_ff.predict_fleet(
            [ref_quantize.quantize_tree(ref_bp, min_size=64), ref_bp],
            [x, x])
    ff = lstm_fleet_forecaster(get_config("lstm-paper"), epochs=1,
                               batch_size=16, device="cpu")
    q = quantize_tree(params_from_numpy(bp, "cpu"), min_size=64)
    a, b = ff.predict_fleet([q, q], [x, x[::-1].copy()])
    np.testing.assert_allclose(a, ff.single.predict(q, x), rtol=0,
                               atol=smoke.UNBATCHED_ATOL)
    np.testing.assert_allclose(b, ff.single.predict(q, x[::-1].copy()),
                               rtol=0, atol=smoke.UNBATCHED_ATOL)


def test_launcher_chaos_on_cpu(single_thread, capsys):
    """``--chaos forged_sync`` end to end at a small size on the CPU: the
    scenario and its fault-free baseline run, every forgery is rejected,
    and the envelope prints."""
    args = edge_cloud.parse_args(["--chaos", "forged_sync", "--streams",
                                  "2", "--windows", "3", "--qps", "4"])
    assert isinstance(args, argparse.Namespace) and args.chaos_seed == 0
    env, res = edge_cloud.run_chaos(args, device="cpu")
    assert env["unhandled_exception"] is None
    assert env["forged_rejected"] == env["fault_stats"]["msg_forge"] > 0
    out = capsys.readouterr().out
    assert "[chaos:forged_sync] 2 streams x 3 windows" in out
    assert "vs fault-free" in out and "forged rejected" in out
