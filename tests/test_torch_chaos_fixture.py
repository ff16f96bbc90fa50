"""The chaos fixture, ``tests/data/torch_parity_chaos.npz``: the JAX
package's chaos runs that ``tests/test_torch_chaos.py`` and the card's
phase 15 replay through the port (``chip_smoke.run_chaos_replay``).

The reference runs each of its eight chaos scenarios, and ``fault_free``
once more under static thresholds (``smoke.CHAOS_RUNS``), on the fleet
fixture's fleet and batch model (``tests/data/torch_parity_fleet.npz``: 3
streams x 4 windows x 150 records, 6 speed epochs at batch 64, run key 1;
``compound_drift`` on its per-stream drift cycle at the same sizes) in the
integrated deployment at a 5 s period (``CostModel(ingest_s=
smoke.BUS_INGEST_S)``), under its ``CHAOS_STAGE_COSTS``, at 8 qps on 4
slots with staleness bound 1, fault seed 0, with a ``HealthPlane``; and
``tests/test_query_plane.py``'s delayed-sync watchdog run
(``smoke.WATCHDOG_RUN``).  Every fleet fit's permutation indices are
recorded by (stream, window, rows): record dropout changes a window's rows,
and so the length of its permutation.  The init params depend on the key
alone, so the replay takes them from the fleet fixture.

``python tests/test_torch_chaos_fixture.py`` writes the fixture (~50 s on
the CPU, 180 KB).
"""
import importlib.util
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as ref_config
from repro.core import FleetStages as RefFleetStages
from repro.core import lstm_fleet_forecaster as ref_fleet_forecaster
from repro.core.scenarios import CHAOS_STAGE_COSTS as REF_CHAOS_STAGE_COSTS
from repro.core.scenarios import ChaosHarness as RefChaosHarness
from repro.core.scenarios import scenario_plane as ref_scenario_plane
from repro.core.scenarios import scenario_quantized as ref_scenario_quantized
from repro.runtime import CostModel as RefCostModel
from repro.runtime import FaultPlane as RefFaultPlane
from repro.runtime import FleetBusExecutor as RefFleetBusExecutor
from repro.runtime import HealthConfig as RefHealthConfig
from repro.runtime import HealthPlane as RefHealthPlane
from repro.runtime import MessageFault as RefMessageFault
from repro.runtime import edge_cloud_integrated as ref_integrated
from repro.runtime import fleet_key_chains as ref_fleet_key_chains
from repro.runtime import paper_topology as ref_topology
from repro.serving.query_plane import open_loop_trace as ref_open_loop_trace
from repro.streams.sources import fleet_windowed_streams as ref_fleet_streams
from repro.training.compiled import bucket_examples as ref_bucket_examples
from repro_torch.core import scenarios

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


def reference_perms(single, data, key) -> np.ndarray:
    """The (epochs * steps, batch) permutation indices the reference's fit
    of ``data`` draws from ``key`` (its fit splits the key and permutes each
    epoch's padded bucket from the second half), as int16."""
    nb = ref_bucket_examples(len(data["x"]), single.batch_size)
    _, perm_key = jax.random.split(key)
    perms = jax.vmap(lambda k: jax.random.permutation(k, nb))(
        jax.random.split(perm_key, single.epochs))
    return np.asarray(perms).reshape(-1, single.batch_size).astype(np.int16)


def _streams(fs, scenario):
    names = [str(x) for x in fs["scenarios"]]
    if scenario == "compound_drift":
        names = scenarios.compound_scenarios(int(fs["n_streams"]))
    streams, _ = ref_fleet_streams(
        int(fs["n_streams"]), int(fs["n_windows"]),
        int(fs["records_per_window"]), names, seed=int(fs["seed"]),
        hist_len=int(fs["hist_len"]),
        alphas=np.full(5, float(fs["drift_alpha"])))
    return streams


def build_fixture():
    """Run the reference's ``smoke.CHAOS_RUNS`` and ``smoke.WATCHDOG_RUN``
    on the fleet fixture's fleet and batch model and return the arrays: the
    setup and stage costs; per run its envelope, fault schedule, health
    verdicts and adaptations, serving statistics and dispatch counts
    (JSON), its bus signature (``bus/{run}/{column}``), queries
    (``q/{run}/{column}``), records and the fits it made (stream, window,
    rows); and every fit's permutation indices
    (``idx/{sid}/w{w}/n{rows}``)."""
    fleet_fx = smoke.load_fixture(smoke.FLEET_FIXTURE)
    fs = smoke.unflatten(fleet_fx, "fsetup")
    ids = [str(x) for x in fs["ids"]]
    bp = jax.tree_util.tree_map(jnp.asarray,
                                smoke.unflatten(fleet_fx, "batch"))
    run_key = jax.random.PRNGKey(int(fs["run_key"]))
    keymap = {tuple(np.asarray(k).tolist()): (sid, w)
              for sid, chain in ref_fleet_key_chains(
                  run_key, ids, int(fs["n_windows"])).items()
              for w, k in enumerate(chain)}
    cs = smoke.CHAOS_SETUP
    out = {f"csetup/{k}": np.asarray(v) for k, v in cs.items()}
    for k, v in REF_CHAOS_STAGE_COSTS.items():
        out[f"costs/chaos/{k}"] = np.asarray(v)
    for k, v in smoke.WATCHDOG.items():
        out[f"watchdog/{k}"] = np.asarray(v)
    # one fleet forecaster for every run: its fits depend on the data and
    # keys alone, and its compiled executables are built once
    ff = ref_fleet_forecaster(ref_config("lstm-paper"),
                              epochs=int(fs["speed_epochs"]),
                              batch_size=int(fs["speed_batch_size"]))
    train_fleet = ff.train_fleet
    made: list = []

    def recording(datas, keys):
        for d, k in zip(datas, keys):
            sid, w = keymap[tuple(np.asarray(k).tolist())]
            n = len(d["x"])
            made.append([sid, w, n])
            if f"idx/{sid}/w{w}/n{n}" not in out:
                out[f"idx/{sid}/w{w}/n{n}"] = reference_perms(ff.single, d,
                                                              k)
        return train_fleet(datas, keys)

    ff.train_fleet = recording
    stages = RefFleetStages.build(ff, mode="dynamic")
    costs = dict(REF_CHAOS_STAGE_COSTS)
    runs = {**smoke.CHAOS_RUNS, smoke.WATCHDOG_RUN: (None, False)}
    for name, (scenario, adaptive) in runs.items():
        made.clear()
        streams = _streams(fs, scenario)
        if scenario is None:
            wd = smoke.WATCHDOG
            plane = RefFaultPlane(wd["fault_seed"], message_faults=[
                RefMessageFault("model/latest/*", "delay", p=1.0,
                                delay_s=wd["delay_s"],
                                start=wd["fault_start"])])
            ex = RefFleetBusExecutor(
                stages, ref_integrated(), ref_topology(),
                window_period_s=cs["period"],
                query_trace=ref_open_loop_trace(
                    ids, wd["qps"], wd["n_requests"], start=wd["start"],
                    seed=wd["trace_seed"]),
                serve_slots=cs["slots"], fault_plane=plane,
                stage_costs=costs, staleness_bound=cs["staleness_bound"])
            res = ex.run(streams, bp, run_key, n_windows=wd["n_windows"])
            scenario = name
        else:
            plane = ref_scenario_plane(scenario, cs["fault_seed"],
                                       cs["period"])
            hp = RefHealthPlane(RefHealthConfig(adaptive=adaptive))
            ex = RefFleetBusExecutor(
                stages, ref_integrated(), ref_topology(),
                RefCostModel(ingest_s=cs["ingest_s"]),
                window_period_s=cs["period"], qps=cs["qps"],
                serve_slots=cs["slots"],
                quantized_sync=ref_scenario_quantized(scenario),
                fault_plane=plane, stage_costs=costs,
                staleness_bound=cs["staleness_bound"], health_plane=hp)
            res = ex.run(streams, bp, run_key)
            out[f"health/{name}"] = np.asarray(json.dumps(
                smoke.chaos_health(ex)))
        env = RefChaosHarness.envelope(
            types.SimpleNamespace(period=cs["period"]), scenario,
            cs["fault_seed"], res)
        out[f"env/{name}"] = np.asarray(json.dumps(env))
        out[f"schedule/{name}"] = np.asarray(json.dumps(
            plane.schedule_signature()))
        for c, v in smoke.bus_columns(res.message_log).items():
            out[f"bus/{name}/{c}"] = v
        for c, v in smoke.query_columns(res.queries, ex._query_lat).items():
            out[f"q/{name}/{c}"] = v
        out[f"serving/{name}"] = np.asarray(json.dumps(res.serving))
        out[f"dispatch/{name}"] = np.asarray(json.dumps(
            {"train": res.train_dispatches, "infer": res.infer_dispatches}))
        out[f"fits/{name}"] = np.asarray(json.dumps(sorted(made)))
        for sid in ids:
            out[f"records/{name}/{sid}"] = smoke.records_array(
                res.results[sid].records)
    return out


def test_fixture_regenerates_from_jax():
    """The committed fixture is what the JAX package produces now: the
    setup, draws, schedules, bus signatures, health, fits, serving
    statistics, dispatch counts and query stamps exactly; envelopes exactly
    but their RMSE to 1e-4; answers and records to 1e-4 (a fit is
    involved)."""
    fx = smoke.load_fixture(smoke.CHAOS_FIXTURE)
    ref = build_fixture()
    assert sorted(ref) == sorted(fx)
    for k, v in ref.items():
        if k.startswith("env/"):
            smoke.check_envelope(json.loads(str(v)), json.loads(str(fx[k])),
                                 1e-4, k)
        elif k.startswith("records/"):
            if v.size == 0:
                assert fx[k].size == 0, k
                continue
            np.testing.assert_array_equal(v[:, 0], fx[k][:, 0])
            np.testing.assert_allclose(v[:, 1:], fx[k][:, 1:], rtol=1e-4,
                                       atol=1e-7, err_msg=k)
        elif k.endswith("/answer"):
            np.testing.assert_allclose(v, fx[k], rtol=1e-4, atol=1e-4,
                                       err_msg=k)
        elif v.dtype.kind == "U" and v.ndim == 0:
            assert json.loads(str(v)) == json.loads(str(fx[k])), k
        else:
            np.testing.assert_array_equal(v, fx[k], err_msg=k)


if __name__ == "__main__":
    smoke.CHAOS_FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(smoke.CHAOS_FIXTURE, **build_fixture())
    print(f"wrote {smoke.CHAOS_FIXTURE} "
          f"({smoke.CHAOS_FIXTURE.stat().st_size} bytes)")
