"""The port's bus-driven executor against the reference's.

The first six tests are the port's counterparts of ``tests/test_executor.py``
on its small setup (1,200 history records, 4 windows of 150, batch and
speed epochs 4 and 6), trained by the port itself on the CPU.  The replay
tests serve the fixture's stream with the reference's published models
(``chip_smoke.run_bus_replay``, the code the smoke run drives on the card)
and hold the bus records to the reference's, float and int8.  Then the
checksummed model sync and the launcher.
"""
import argparse
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import (
    PipelineStages,
    WindowedStream,
    WindowPlan,
    lstm_forecaster,
    make_supervised,
    pretrain_batch_model,
)
from repro_torch.launch import edge_cloud
from repro_torch.runtime import (
    BusExecutor,
    CapacityError,
    CostModel,
    InProcessExecutor,
    Message,
    cloud_centric,
    edge_centric,
    edge_cloud_integrated,
    paper_topology,
    window_seeds,
)
from repro_torch.runtime.executor import warmup_seed
from repro_torch.runtime.modules import T_MODEL
from repro_torch.serving.quantize import QTensor, tree_checksum, tree_leaves
from repro_torch.streams.normalize import MinMaxScaler
from repro_torch.streams.sources import gradual_drift, wind_turbine_series

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

N_WINDOWS = 4


@pytest.fixture(scope="module")
def single_thread():
    """The port's many small CPU operators run faster single-threaded, and
    leave the worker's other cores alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup(single_thread):
    cfg = get_config("lstm-paper")
    series = wind_turbine_series(1200 + 150 * N_WINDOWS, seed=0)
    hist, stream_raw = series[:1200], series[1200:]
    stream_raw = gradual_drift(stream_raw, alphas=np.full(5, 1.5e-3), seed=1)
    scaler = MinMaxScaler.fit(hist)
    fc_batch = lstm_forecaster(cfg, epochs=4, batch_size=256, device="cpu")
    fc_speed = lstm_forecaster(cfg, epochs=6, batch_size=64, device="cpu")
    bp, _ = pretrain_batch_model(
        fc_batch, make_supervised(scaler.transform(hist), 5, 0), 0)
    stream = WindowedStream(scaler.transform(stream_raw),
                            WindowPlan(N_WINDOWS, 150, lag=5))
    stages = PipelineStages.build(fc_speed, mode="dynamic")
    return stages, bp, stream


_RUNS = {}


def bus_run(setup, dep, strict=False, period=30.0, quantized=False):
    """One bus run of the small setup, cached per arguments: a run is
    deterministic apart from its measured walls."""
    key = (dep.name, strict, period, quantized)
    if key not in _RUNS:
        stages, bp, stream = setup
        ex = BusExecutor(stages, dep, paper_topology(),
                         CostModel(ingest_s=0.5), strict_capacity=strict,
                         window_period_s=period, quantized_sync=quantized)
        _RUNS[key] = ex.run(stream, bp, 1)
    return _RUNS[key]


def test_inprocess_and_bus_identical_rmse(setup):
    """Same stages + same seed -> identical per-window accuracy, whether the
    pipeline runs as the synchronous loop or bus-scheduled on a deployment
    where speed training succeeds."""
    stages, bp, stream = setup
    sync = InProcessExecutor(stages).run(stream, bp, 1)
    for dep in (edge_cloud_integrated(), cloud_centric()):
        bus = bus_run(setup, dep)
        assert len(bus.records) == len(sync.records) == N_WINDOWS - 1
        for rs, rb in zip(sync.records, bus.records):
            assert rs.window == rb.window
            assert rs.rmse_batch == pytest.approx(rb.rmse_batch, abs=1e-12)
            assert rs.rmse_speed == pytest.approx(rb.rmse_speed, abs=1e-12)
            assert rs.rmse_hybrid == pytest.approx(rb.rmse_hybrid, abs=1e-12)
            assert rs.w_speed == pytest.approx(rb.w_speed, abs=1e-12)


def test_edge_centric_bus_records_oom(setup):
    """Speed training placed on the Pi fails every window; no model is ever
    published, so the speed layer serves the batch model (fallback)."""
    res = bus_run(setup, edge_centric())
    assert len(res.failures) == N_WINDOWS
    assert "OOM" in res.failures[0]
    assert not [m for m in res.message_log if m.topic == T_MODEL]
    for r in res.records:
        assert r.rmse_speed == pytest.approx(r.rmse_batch, abs=1e-12)
    with pytest.raises(CapacityError):
        bus_run(setup, edge_centric(), strict=True)


def test_measured_e2e_latency_ordering(setup):
    """Paper Table 3 on real compute: integrated < cloud-centric (WAN round
    trip) < edge-centric (single-worker Pi thrashed by the training
    attempt); and every Table-3 claim of the launcher holds."""
    runs = {dep.name: bus_run(setup, dep) for dep in
            (edge_cloud_integrated(), cloud_centric(), edge_centric())}
    e2e = {name: r.mean_e2e_s() for name, r in runs.items()}
    assert (e2e["edge-cloud-integrated"] < e2e["cloud-centric"]
            < e2e["edge-centric"]), e2e
    checks = edge_cloud.table3_claim_checks(runs)
    assert len(checks) == 5 and all(checks.values()), checks


def test_stale_model_inference_from_event_ordering(setup):
    """With the window period shrunk below the training time, window 1 is
    inferred before any model sync lands (cold-start fallback): M^s_{t-1}
    staleness emerging from event ordering, not loop order."""
    fresh = bus_run(setup, edge_cloud_integrated(), period=30.0)
    stale = bus_run(setup, edge_cloud_integrated(), period=1e-4)
    assert fresh.records[0].rmse_speed != pytest.approx(
        fresh.records[0].rmse_batch, abs=1e-12)
    assert stale.records[0].rmse_speed == pytest.approx(
        stale.records[0].rmse_batch, abs=1e-12)


def test_quantized_sync_serves_int8_model(setup):
    """``quantized_sync=True``: the model topic carries the int8 byte count
    (below 0.45x of float), the published params hold QTensor leaves, and
    per-window speed RMSE stays within 5% of the float run's."""
    res_f = bus_run(setup, edge_cloud_integrated())
    res_q = bus_run(setup, edge_cloud_integrated(), quantized=True)
    nb_f = [m.nbytes for m in res_f.message_log if m.topic == T_MODEL]
    nb_q = [m.nbytes for m in res_q.message_log if m.topic == T_MODEL]
    assert nb_f and nb_q
    assert max(nb_q) < 0.45 * min(nb_f)
    qmsg = next(m for m in res_q.message_log if m.topic == T_MODEL)
    assert any(isinstance(v, QTensor)
               for sub in qmsg.payload["params"].values()
               for v in sub.values())
    for rf, rq in zip(res_f.records, res_q.records):
        assert rq.rmse_speed == pytest.approx(rf.rmse_speed, rel=0.05)


def test_bus_ledger_and_e2e_structure(setup):
    res = bus_run(setup, edge_cloud_integrated())
    t = res.table3()
    for mod in ("batch_inference", "speed_inference", "hybrid_inference",
                "speed_training", "model_sync", "data_sync"):
        assert mod in t
        assert t[mod]["total"] >= 0.0
    assert t["batch_inference"]["computation"] > 0
    assert t["speed_training"]["computation"] > 0
    assert set(res.e2e_s) == {w for w in range(1, N_WINDOWS)}
    assert all(v > 0 for v in res.e2e_s.values())


# fixed virtual stage walls for the replays (the reference's chaos-suite
# costs, core/scenarios.py: CHAOS_STAGE_COSTS).  The records equal the
# in-process ones only when window t's weight solve runs after model t-1 is
# installed and before model t is; on a loaded CPU the edge's measured
# inference can outlast the cloud's replayed fit plus its WAN transfer and
# let model t in first.  On the card the margin is two orders of magnitude,
# and chip_smoke.py replays with measured walls.
REPLAY_STAGE_COSTS = {"batch_inference": 0.05, "speed_inference": 0.05,
                      "hybrid_inference": 0.01, "speed_training": 0.5,
                      "model_sync": 0.01, "data_sync": 0.005}


@pytest.fixture(scope="module")
def replays(single_thread):
    fx = smoke.load_fixture()
    runs = {d: smoke.run_bus_replay(fx, "cpu", d,
                                    stage_costs=REPLAY_STAGE_COSTS)
            for d in smoke.BUS_DEPLOYMENTS}
    runs["int8"] = smoke.run_bus_replay(fx, "cpu", "edge-cloud-integrated",
                                        quantized=True,
                                        stage_costs=REPLAY_STAGE_COSTS)
    return fx, runs


def test_bus_replay_reproduces_reference_records(replays):
    """Serving the reference's models, integrated and cloud-centric bus
    runs reproduce its in-process dynamic_closed_form records (RMSEs rtol
    1e-5, weights atol 1e-5) with 31,124 B model publishes; edge-centric
    OOMs every window and serves the batch model."""
    fx, runs = replays
    assert smoke.check_bus_float(fx, runs, rtol=1e-5, atol=1e-5) < 1e-5
    assert smoke.expected_bus_launches(runs["edge-centric"], False, 5) == {
        "lstm_sequence_fused": 3 + 5 + 5, "int8_matmul": 0}


def test_bus_replay_int8_reproduces_reference(replays):
    """Under int8 sync: 9,644 B publishes whose q and scale equal the
    reference's bit for bit, int8 predictions within 1e-5 of its
    int8pred{t}, records within rtol 1e-4 of its bus_int8_integrated (it
    serves dequantized floats off the TPU), 7 int8 products a predict."""
    fx, runs = replays
    worst_pred, worst = smoke.check_bus_int8(fx, runs["int8"], rtol=1e-4)
    assert worst_pred <= 1e-5 and worst < 1e-4
    assert smoke.expected_bus_launches(runs["int8"], True, 5) == {
        "lstm_sequence_fused": 3 + 2 * 6 + 5, "int8_matmul": 7 * (5 + 1)}


def test_model_sync_rejects_a_corrupt_publish(replays):
    """A publish whose checksum does not match is rejected: the counter
    rises, the transfer is accounted, and nothing is installed; the genuine
    publish then installs and verifies."""
    fx, runs = replays
    pub = next(m for m in runs["int8"].message_log if m.topic == T_MODEL)
    stages = PipelineStages.build(object())
    ex = BusExecutor(stages, edge_cloud_integrated(), paper_topology())
    ex._reset()
    bad = Message(T_MODEL, dict(pub.payload,
                                checksum=pub.payload["checksum"] ^ 1),
                  pub.nbytes, "cloud", publish_time=0.0, deliver_time=0.05)
    ex._on_model_sync(bad)
    ms = stages.model_sync
    assert (ms.corrupt_rejected, ms.verified) == (1, 0)
    assert ex._model.params is None and ex._model.window == -1
    assert ex.ledger.comm["model_sync"] == [0.05]
    ex._on_model_sync(pub)
    assert (ms.corrupt_rejected, ms.verified) == (1, 1)
    assert ex._model.params is pub.payload["params"]
    assert pub.payload["checksum"] == tree_checksum(pub.payload["params"])


def test_warmup_key_is_no_window_key():
    for seed in range(20):
        assert warmup_seed(seed) not in window_seeds(seed, 64)
        assert warmup_seed(seed) == warmup_seed(seed)


def test_stage_sync_sees_quantized_leaves():
    """Stage.__call__ syncs every tensor it returns, a QTensor's q and scale
    among them."""
    from repro_torch.core.stages import _tensor_leaves

    q, s = torch.zeros((2, 3), dtype=torch.int8), torch.ones(3)
    out = {"speed_params": {"l": {"w": QTensor(q, s, "float32"),
                                  "b": torch.zeros(3)}}, "ok": True}
    leaves = list(_tensor_leaves(out))
    assert len(leaves) == 3 and leaves[1] is q and leaves[2] is s
    assert list(tree_leaves([None, (1.0,)])) == [1.0]


@pytest.mark.parametrize("flags,slice_", [
    (["--real", "--gated"], "requires --streams > 1"),
    (["--real", "--qps", "8"], "--qps requires fleet mode"),
    (["--real", "--elastic"], "--elastic requires fleet mode"),
    (["--chaos", "nope"], "pick from"),
    ([], "ports the benchmarks"),
])
def test_launcher_refuses_modes_not_ported(flags, slice_, capsys):
    with pytest.raises(SystemExit) as err:
        edge_cloud.parse_args(["--deployment", "all", *flags])
    assert err.value.code == 2
    assert slice_ in capsys.readouterr().err


def test_launcher_runs_all_deployments_on_cpu(single_thread, capsys):
    """The launcher end to end at its fixed sizes, two windows, int8 sync:
    every Table-3 claim holds and prints PASS."""
    args = edge_cloud.parse_args(["--real", "--deployment", "all", "--fast",
                                  "--windows", "2", "--quantized"])
    assert isinstance(args, argparse.Namespace)
    runs = edge_cloud.run_real(args, device="cpu")
    assert set(runs) == set(smoke.BUS_DEPLOYMENTS)
    out = capsys.readouterr().out
    assert out.count("PASS") == 7 and "FAIL" not in out
    assert "model topic: 2 publishes of [9644] bytes" in out
