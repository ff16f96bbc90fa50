"""``tests/test_chaos.py``'s properties on the port: the event kernel and
the bus's dead letters, and the end-to-end properties the chaos bench gates
on, run by the port's own ``ChaosHarness`` at the reference test's size (2
streams x 4 windows x 80 records, a 5 s period, 6 qps) on the CPU.  One
fault seed reproduces a run byte for byte; corrupted int8 publishes are
never installed; a stream whose sensor goes dark is quarantined by the
aggregation flush without stalling the fleet, and revives; forged publishes
are HMAC-rejected and re-requested; partitions are detected within two
heartbeat intervals with no fault-free false positives; the adaptive path
is byte-identical to static thresholds when calm.  The draws are the
port's own, so these hold the properties, not the reference's numbers
(``tests/test_torch_chaos.py`` does that)."""
import pytest
import torch

from repro.runtime import EventKernel as RefEventKernel
from repro_torch.core.scenarios import (
    RMSE_RATIO_MAX,
    ChaosHarness,
    bus_signature,
    forecast_signature,
    ledger_signature,
)
from repro_torch.runtime.modules import T_SPEED
from repro_torch.runtime import (
    EventKernel,
    FaultPlane,
    MessageFault,
    SensorFault,
    Site,
    TopicBus,
    Topology,
)

SEED = 0
PERIOD = 5.0
RUN_KEY = 1


@pytest.fixture(scope="module")
def harness():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield ChaosHarness(n_streams=2, n_windows=4, records_per_window=80,
                       period_s=PERIOD, qps=6.0, device="cpu")
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fault_free(harness):
    return harness.run_scenario("fault_free", seed=SEED)


def _run(harness, plane, **kw):
    ex = harness.executor(plane, **kw)
    return ex.run(harness._base_streams, harness.bp, RUN_KEY)


# ---------------------------------------------------------------------------
# kernel and bus primitives
# ---------------------------------------------------------------------------


def test_kernel_run_until_pauses_and_resumes_in_order():
    """``run(until=)`` consumes no event beyond the horizon: pausing and
    resuming replays the rest in (time, FIFO) order, ties included, as the
    reference's kernel does."""
    fired = {}
    for name, cls in (("port", EventKernel), ("ref", RefEventKernel)):
        k = cls()
        log = fired[name] = []
        for ev, t in [("a", 1.0), ("b", 2.0), ("b2", 2.0), ("c", 3.0)]:
            k.at(t, lambda n=ev, k=k, log=log: log.append((n, k.now)))
        k.run(until=1.5)
        assert log == [("a", 1.0)]
        k.run(until=2.0)
        assert log == [("a", 1.0), ("b", 2.0), ("b2", 2.0)]
        k.run()
    assert fired["port"] == fired["ref"] == [
        ("a", 1.0), ("b", 2.0), ("b2", 2.0), ("c", 3.0)]


def test_publish_without_link_is_dead_lettered_not_raised():
    topo = Topology(sites={
        "edge": Site("edge", "edge", compute_scale=1.0, memory_bytes=1e9,
                     workers=1),
        "cloud": Site("cloud", "cloud", compute_scale=1.0, memory_bytes=1e9,
                      workers=1),
    }, links={})
    k = EventKernel()
    bus = TopicBus(k, topo, fault_plane=FaultPlane(0))
    got = []
    bus.subscribe("data/+", "cloud", lambda m: got.append(m))
    bus.publish("data/t00", {"x": 1}, src="edge", nbytes=8.0)
    k.run()
    assert got == []
    assert len(bus.dead_letters) == 1
    dl = bus.dead_letters[0]
    assert dl.topic == "data/t00" and dl.reason == "no-link"
    assert (dl.src, dl.dst) == ("edge", "cloud")


# ---------------------------------------------------------------------------
# end-to-end properties (small fleet, one pretrain for the module)
# ---------------------------------------------------------------------------


def test_same_seed_same_run_different_seed_differs(harness):
    """One fault seed reproduces the whole run byte for byte (bus log,
    latency ledger, forecasts and served answers); another seed gives
    another fault schedule."""
    _, r1 = harness.run_scenario("sensor_chaos", seed=SEED)
    _, r2 = harness.run_scenario("sensor_chaos", seed=SEED)
    _, r3 = harness.run_scenario("sensor_chaos", seed=SEED + 7)
    assert bus_signature(r1) == bus_signature(r2)
    assert ledger_signature(r1) == ledger_signature(r2)
    assert forecast_signature(r1) == forecast_signature(r2)
    assert bus_signature(r1) != bus_signature(r3)


def test_fault_free_is_parity_with_the_plain_run(harness, fault_free):
    """An empty fault plane (and a calm health plane) changes nothing: the
    forecasts, served answers and fleet fits equal the plane-less run's."""
    env, res = fault_free
    plain = harness.run_plain()
    assert forecast_signature(res) == forecast_signature(plain)
    assert env["train_dispatches"] == plain.train_dispatches
    assert abs(env["rmse_hybrid"] - plain.mean_rmse()["hybrid"]) <= 1e-12


def test_corrupted_sync_always_detected_never_installed(harness):
    """Every int8 model publish bit-flipped: the checksum rejects each one,
    no speed model is ever installed, serving never leaves the fallback,
    and the re-request path runs (bounded)."""
    plane = FaultPlane(SEED, message_faults=[
        MessageFault("model/latest/*", "corrupt", p=1.0)])
    res = _run(harness, plane, quantized=True)
    chaos = res.chaos
    assert chaos["fault_stats"]["msg_corrupt"] > 0
    assert chaos["corrupt_rejected"] == chaos["fault_stats"]["msg_corrupt"]
    assert chaos["checksum_verified"] == 0
    for q in res.queries:
        assert q.served_fallback or q.model_window < 0
    assert all(p is None for p in res.final_params.values())
    assert chaos["resync_requests"] > 0
    assert chaos["fault_stats"]["resync_gave_up"] > 0


def test_dark_sensor_stream_is_quarantined_fleet_continues(harness):
    """t00's sensor goes dark after window 0: the aggregation flush
    dispatches t01 alone, t00 is quarantined after repeated misses, and the
    healthy stream scores every window."""
    plane = FaultPlane(SEED, sensor_faults=[
        SensorFault(stream="t00", p_drop_window=1.0, start=0.9 * PERIOD)])
    res = _run(harness, plane)
    assert "t00" in res.chaos["quarantined"]
    assert res.chaos["fault_stats"]["stream_quarantined"] >= 1
    assert res.chaos["fault_stats"]["agg_flush"] >= 1
    assert len(res.results["t01"].records) == harness.n_windows - 1
    assert (len(res.results["t00"].records)
            < len(res.results["t01"].records))
    assert res.train_dispatches >= 1


def test_fault_free_run_has_zero_health_false_positives(fault_free):
    """A calm run: no suspicion, no Byzantine flag, no signature rejection,
    no threshold adaptation."""
    env, _ = fault_free
    h = env["health"]
    assert h["n_suspected"] == 0 and h["n_site_down"] == 0
    assert h["byz_flagged"] == 0 and h["byz_screened"] > 0
    assert env["forged_rejected"] == 0
    assert h["threshold_adaptations"] == 0


def test_partition_detected_within_two_heartbeat_intervals(harness):
    env, _ = harness.run_scenario("partitioned_sync", seed=SEED)
    h = env["health"]
    assert h["n_suspected"] >= 1
    assert h["detection_latency_hb_intervals"] <= 2.0
    assert h["n_recovered"] >= 1


def test_forged_sync_always_hmac_rejected_never_installed(harness):
    """Every int8 publish forged with a recomputed CRC32: the checksum
    layer catches nothing, the HMAC catches every one, and no forged model
    is ever served."""
    plane = FaultPlane(SEED, message_faults=[
        MessageFault("model/latest/*", "forge", p=1.0)])
    res = _run(harness, plane, quantized=True, health_plane=harness.health)
    chaos = res.chaos
    assert chaos["fault_stats"]["msg_forge"] > 0
    assert chaos["forged_rejected"] == chaos["fault_stats"]["msg_forge"]
    assert chaos["fault_stats"]["sync_sig_rejected"] == \
        chaos["forged_rejected"]
    assert chaos["corrupt_rejected"] == 0
    for q in res.queries:
        assert q.served_fallback or q.model_window < 0
    assert chaos["resync_requests"] > 0


def test_int8_fleet_serves_quantized_fallback_beside_synced_streams(
        harness):
    """Every int8 publish of t00 forged: t00 never installs a model while
    t01 does, so every stacked speed predict mixes the two.  t00 serves
    its batch model's int8 copy beside t01's int8 model, flagged as the
    fallback, and the run completes (the reference stacks the float batch
    tree beside the int8 ones there and raises,
    ``tests/test_torch_chaos.py``)."""
    plane = FaultPlane(SEED, message_faults=[
        MessageFault("model/latest/t00", "forge", p=1.0)])
    res = _run(harness, plane, quantized=True, health_plane=harness.health)
    chaos = res.chaos
    assert chaos["forged_rejected"] == chaos["fault_stats"]["msg_forge"] > 0
    assert res.final_params["t00"] is None
    assert res.final_params["t01"] is not None
    for sid in ("t00", "t01"):
        assert len(res.results[sid].records) == harness.n_windows - 1
    speed = [m.payload for m in res.message_log
             if m.topic.startswith(T_SPEED + "/")]
    assert speed and all(p["fallback"] == (p["stream"] == "t00")
                         for p in speed)


def test_forged_sync_scenario_recovers_via_resync(harness):
    """At forge p = 0.5 the reject, re-request, accept loop lands clean
    models: every forgery rejected, yet speed models install and serve."""
    env, res = harness.run_scenario("forged_sync", seed=SEED)
    assert env["unhandled_exception"] is None
    assert env["fault_stats"]["msg_forge"] > 0
    assert env["forged_rejected"] == env["fault_stats"]["msg_forge"]
    assert env["resync_requests"] > 0
    assert env["checksum_verified"] > 0
    assert any(q.model_window >= 0 and not q.served_fallback
               for q in res.queries)


def test_byzantine_values_flagged_imputed_within_envelope(harness,
                                                          fault_free):
    env, _ = harness.run_scenario("byzantine", seed=SEED)
    env_ff, _ = fault_free
    assert env["health"]["byz_flagged"] > 0
    assert env["quarantined"] == {}
    ratio = env["rmse_hybrid"] / env_ff["rmse_hybrid"]
    assert ratio <= RMSE_RATIO_MAX["byzantine"]


def test_quarantined_stream_revives_under_adaptive_thresholds(harness):
    """t00 dark long enough to be quarantined (its misses feed its fault
    rate and tighten its threshold), then back: revived by the end, scored
    after revival."""
    plane = FaultPlane(SEED, sensor_faults=[
        SensorFault(stream="t00", p_drop_window=1.0, start=0.9 * PERIOD,
                    end=2.9 * PERIOD)])
    res = _run(harness, plane, health_plane=harness.health)
    stats = res.chaos["fault_stats"]
    assert stats["stream_quarantined"] >= 1
    assert stats["quarantine_revived"] >= 1
    assert "t00" not in res.chaos["quarantined"]
    assert len(res.results["t00"].records) >= 1
    assert res.health["threshold_adaptations"] >= 1
    assert res.health["adapted_quarantine_after"].get("t00", 99) \
        < res.health["base_quarantine_after"]


def test_adaptive_calm_run_byte_identical_to_static_thresholds(harness,
                                                               fault_free):
    _, r_adaptive = fault_free
    _, r_static = harness.run_scenario("fault_free", seed=SEED,
                                       adaptive=False)
    assert bus_signature(r_adaptive) == bus_signature(r_static)
    assert ledger_signature(r_adaptive) == ledger_signature(r_static)
    assert forecast_signature(r_adaptive) == forecast_signature(r_static)


@pytest.mark.parametrize("name", ["site_crash", "sensor_chaos",
                                  "corrupted_int8_sync", "compound_drift"])
def test_scenario_holds_its_envelope(harness, fault_free, name):
    """Each remaining scenario runs without an exception and keeps its
    hybrid RMSE within its envelope of the fault-free run's; every request
    is answered or counted starved."""
    env, res = harness.run_scenario(name, seed=SEED)
    env_ff, _ = fault_free
    assert env["unhandled_exception"] is None
    assert env["rmse_hybrid"] / env_ff["rmse_hybrid"] <= RMSE_RATIO_MAX[name]
    assert env["n_answered"] + env["n_starved"] == \
        res.serving["n_requests"]
    if name == "compound_drift":
        assert len(harness.streams_for(name)) == harness.n_streams
    if name == "site_crash":
        assert env["fault_stats"]["site_restart"] == 1


def test_scenario_exception_is_a_failed_envelope(harness, monkeypatch):
    """A run that raises comes back as an envelope carrying the exception,
    and nothing else: no number of a crashed run can pass for a result."""
    def boom(*a, **k):
        raise RuntimeError("injected")

    monkeypatch.setattr(harness.stages.speed_training, "compute", boom)
    env, res = harness.run_scenario("fault_free", seed=SEED)
    assert res is None
    assert env == {"scenario": "fault_free", "seed": SEED,
                   "unhandled_exception": "RuntimeError: injected"}
