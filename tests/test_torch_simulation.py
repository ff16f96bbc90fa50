"""The port's calibrated Table-3 simulation, throttle buffer and CSV source,
held to the reference's.

``EdgeCloudSimulation`` runs on the host and draws nothing, so for the same
``CostModel`` the port's tables, failures and message log must equal the
reference's exactly, in every deployment and weighting mode, at
``tests/test_runtime.py``'s costs.  The throttle buffer, ``stream_windows``
and the CSV reader are numpy copies, held to the reference's on its own
tests' cases.  Then the launcher's default mode end to end on the CPU.
"""
import argparse
import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch

from repro.runtime import CostModel as RefCostModel
from repro.runtime import EdgeCloudSimulation as RefSimulation
from repro.runtime import ALL_DEPLOYMENTS as REF_DEPLOYMENTS
from repro.runtime import paper_topology as ref_topology
from repro.runtime.bus import CapacityError as RefCapacityError
from repro.streams import csv_source as ref_csv
from repro.streams.injection import DataInjection as RefInjection
from repro.streams.injection import ThrottleConfig as RefThrottle
from repro.streams.injection import stream_windows as ref_stream_windows

from repro_torch.launch import edge_cloud
from repro_torch.runtime import (
    ALL_DEPLOYMENTS,
    CapacityError,
    CostModel,
    EdgeCloudSimulation,
    SimulationResult,
    paper_topology,
)
from repro_torch.streams import (
    DataInjection,
    ThrottleConfig,
    csv_source,
    stream_windows,
)
from repro_torch.streams.sources import wind_turbine_series

# tests/test_runtime.py's costs, and its paper-scale window and large model
COSTS = dict(batch_infer_s=2.0, speed_infer_s=2.1, hybrid_combine_s=1.5,
             weight_solve_s=0.6, speed_train_s=7.0, ingest_s=3.0)
CASES = {"default": {}, "paper_window": {"window_nbytes": 8e6},
         "large_model": {"model_nbytes": 2.5e6}}
N_WINDOWS = 20


def simulate(sim_cls, cost_cls, deployments, topology, name, dynamic,
             case, strict=False):
    cost = cost_cls(**COSTS, **CASES[case])
    sim = sim_cls(deployments[name](), topology(), cost,
                  dynamic_weighting=dynamic, strict_capacity=strict)
    return sim.run(N_WINDOWS)


def log_rows(res):
    return [(m.topic, dict(m.payload), m.nbytes, m.src, m.publish_time,
             m.deliver_time) for m in res.message_log]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dynamic", [True, False])
@pytest.mark.parametrize("name", list(REF_DEPLOYMENTS))
def test_simulation_equals_reference(name, dynamic, case):
    """Table 3, the failures and every message (topic, payload, bytes,
    site, times) equal to the reference's, float for float."""
    ref = simulate(RefSimulation, RefCostModel, REF_DEPLOYMENTS, ref_topology,
                   name, dynamic, case)
    got = simulate(EdgeCloudSimulation, CostModel, ALL_DEPLOYMENTS,
                   paper_topology, name, dynamic, case)
    assert isinstance(got, SimulationResult)
    assert got.n_windows == ref.n_windows == N_WINDOWS
    assert got.table3() == ref.table3()
    assert got.failures == ref.failures
    assert log_rows(got) == log_rows(ref)
    assert len(got.message_log) > N_WINDOWS


def test_cost_model_defaults_equal_reference():
    assert dataclasses.asdict(CostModel()) == dataclasses.asdict(
        RefCostModel())


def test_strict_capacity_raises_as_reference():
    with pytest.raises(RefCapacityError) as ref:
        simulate(RefSimulation, RefCostModel, REF_DEPLOYMENTS, ref_topology,
                 "edge-centric", True, "default", strict=True)
    with pytest.raises(CapacityError) as got:
        simulate(EdgeCloudSimulation, CostModel, ALL_DEPLOYMENTS,
                 paper_topology, "edge-centric", True, "default",
                 strict=True)
    assert str(got.value) == str(ref.value)
    assert "OOM" in str(got.value)
    # where training fits, strict changes nothing
    a = simulate(EdgeCloudSimulation, CostModel, ALL_DEPLOYMENTS,
                 paper_topology, "edge-cloud-integrated", True, "default",
                 strict=True)
    assert a.failures == [] and "speed_training" in a.table3()


def _drive_injection(cls, cfg_cls):
    """tests/test_windows_streams.py's throttle case, every observable
    recorded."""
    inj = cls(cfg_cls(min_records=10, max_buffer=15))
    rng = np.random.default_rng(0)
    seen = []
    inj.push(rng.normal(size=(8, 3)))
    seen.append((inj.ready(), inj.emit()))
    inj.push(rng.normal(size=(4, 3)))
    seen.append((inj.ready(), inj.emit(), inj.emitted_windows))
    inj.push(rng.normal(size=(20, 3)))
    seen.append((inj.dropped, inj.ready(), inj.emit(), inj.emitted_windows,
                 inj.ingest_seconds(250)))
    inj.push(rng.normal(size=3))  # one record
    seen.append((inj.ready(), len(inj._buffer)))
    return seen


def test_data_injection_equals_reference():
    ref = _drive_injection(RefInjection, RefThrottle)
    got = _drive_injection(DataInjection, ThrottleConfig)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert len(g) == len(r)
        for a, b in zip(g, r):
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b
    assert got[1][1].shape == (12, 3) and got[2][0] == 5
    assert dataclasses.asdict(ThrottleConfig()) == dataclasses.asdict(
        RefThrottle())


@pytest.mark.parametrize("n,rpw", [(103, 25), (100, 25), (24, 25), (0, 5)])
def test_stream_windows_equal_reference(n, rpw):
    s = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    got, ref = stream_windows(s, rpw), ref_stream_windows(s, rpw)
    assert len(got) == len(ref) == n // rpw
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_csv_round_trip_equals_reference():
    data = wind_turbine_series(200, seed=0)
    with tempfile.TemporaryDirectory() as d:
        ours, theirs = os.path.join(d, "a.csv"), os.path.join(d, "b.csv")
        csv_source.write_csv(ours, data)
        ref_csv.write_csv(theirs, data)
        with open(ours) as fa, open(theirs) as fb:
            assert fa.read() == fb.read()
        back = csv_source.read_csv(ours)
        np.testing.assert_array_equal(back, ref_csv.read_csv(ours))
        np.testing.assert_array_equal(
            csv_source.read_csv(ours, max_rows=10),
            ref_csv.read_csv(ours, max_rows=10))
    np.testing.assert_allclose(back, data, atol=1e-3)
    assert back.dtype == np.float32
    assert csv_source.PAPER_CHANNELS == ref_csv.PAPER_CHANNELS


@pytest.mark.parametrize("text", [
    # column selection and order
    "Date_time,Ot_avg,Db1t_avg,junk,Db2t_avg,Gb1t_avg,Gb2t_avg\n"
    "t0,10,1,x,2,3,4\nt1,11,5,y,6,7,8\n",
    # gaps forward-filled
    "Db1t_avg,Db2t_avg,Gb1t_avg,Gb2t_avg,Ot_avg\n1,2,3,4,5\n,NA,3.5,nan,6\n",
    # leading incomplete rows dropped, a short row and an unparsable value
    "Db1t_avg,Db2t_avg,Gb1t_avg,Gb2t_avg,Ot_avg\n,2,3,4,5\n1,2,3,4,5\n"
    "7,x,8\n",
])
def test_csv_parsing_equals_reference(text):
    got, ref = csv_source.read_csv_str(text), ref_csv.read_csv_str(text)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_csv_missing_column_raises():
    with pytest.raises(KeyError, match="Ot_avg"):
        csv_source.read_csv_str("Db1t_avg,Db2t_avg,Gb1t_avg,Gb2t_avg\n1,2,3,4\n")


def test_launcher_default_mode_on_cpu(capsys):
    """``--deployment all --fast --windows 3`` calibrated on the CPU: three
    Table-3 blocks, edge-centric's three OOM failures, the reference's
    non-timing constants (printed) and the paper's orderings."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        args = edge_cloud.parse_args(["--deployment", "all", "--fast",
                                      "--windows", "3"])
        assert isinstance(args, argparse.Namespace) and not args.real
        runs = edge_cloud.run_calibrated(args, device="cpu")
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert out.count("windows, dynamic weighting") == 3
    assert "calibration: {" in out and "'speed_epochs': 10" in out
    assert set(runs) == set(ALL_DEPLOYMENTS)
    assert len(runs["edge-centric"].failures) == 3
    assert "!! 3 failures (first: speed_training OOM on edge" in out
    assert not runs["cloud-centric"].failures
    assert not runs["edge-cloud-integrated"].failures
    cloud = runs["cloud-centric"].table3()
    integ = runs["edge-cloud-integrated"].table3()
    for mod in ("batch_inference", "speed_inference"):
        assert cloud[mod]["communication"] > integ[mod]["communication"]
    assert integ["batch_inference"]["computation"] > \
        cloud["batch_inference"]["computation"]
    assert "speed_training" not in runs["edge-centric"].table3()
