"""The port's fleet held to the JAX package: ``FleetForecaster``, the fleet
stages, drift gating and both fleet executors.

The setup is ``tests/test_fleet.py``'s: three correlated turbines
("none", "gradual", "abrupt"), 4 windows of 150 records, history 1200,
speed fits of 6 epochs at batch 64.  The reference runs it live here in
``smoke.FLEET_RUNS``' four ways (``InProcessFleetExecutor``, and
``FleetBusExecutor`` in the integrated deployment with float sync, int8 sync
and drift-gated), recording every fleet fit's draws (each stream's init
params and epoch permutations, which torch cannot reproduce from a
``jax.random`` key), its trained params and its per-step losses.  The port
runs the same four from those draws (``chip_smoke.run_fleet_replay``, the
code the card runs) and must reproduce every fit and every record to 1e-5.
Then the properties of ``tests/test_fleet.py``, on the port.

``python tests/test_torch_fleet.py`` writes the card's copy of the
reference's arrays, ``tests/data/torch_parity_fleet.npz``.
"""
import importlib.util
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import FleetStages as RefFleetStages
from repro.core import lstm_fleet_forecaster as ref_fleet_forecaster
from repro.core import lstm_forecaster as ref_forecaster
from repro.core import pretrain_batch_model as ref_pretrain
from repro.core.drift import DriftGate as RefDriftGate
from repro.runtime import CostModel as RefCostModel
from repro.runtime import FleetBusExecutor as RefFleetBusExecutor
from repro.runtime import InProcessFleetExecutor as RefInProcessFleetExecutor
from repro.runtime import edge_cloud_integrated as ref_integrated
from repro.runtime import fleet_key_chains as ref_fleet_key_chains
from repro.runtime import paper_topology as ref_topology
from repro.serving.quantize import QTensor as RefQTensor
from repro.serving.quantize import quantize_tree as ref_quantize_tree
from repro.streams.sources import fleet_windowed_streams as ref_fleet_streams
from repro.training.compiled import bucket_examples as ref_bucket_examples
from repro_torch.configs import get_config as port_config
from repro_torch.core import (
    BatchRefresh,
    DriftGate,
    FleetStages,
    FleetState,
    lstm_fleet_forecaster,
    lstm_forecaster,
    pretrain_batch_model,
    resolve_fleet_params,
)
from repro_torch.models.model import get_model
from repro_torch.runtime import (
    CostModel,
    FleetBusExecutor,
    InProcessFleetExecutor,
    edge_centric,
    edge_cloud_integrated,
    paper_topology,
)
from repro_torch.runtime.modules import T_MODEL, T_RESYNC, T_STREAM
from repro_torch.serving.quantize import (
    QTensor,
    quantize_fleet,
    quantize_tree,
    tree_checksum,
    tree_nbytes,
)
from repro_torch.streams.sources import fleet_windowed_streams
from repro_torch.training.compiled import (
    CompiledForecaster,
    FleetForecaster,
    FleetParamView,
    bucket_streams,
)
from repro_torch.training.optimizer import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

# the tests/test_fleet.py setup
SETUP = {"n_streams": 3, "n_windows": 4, "records_per_window": 150,
         "seed": 0, "hist_len": 1200, "drift_alpha": 1.5e-3,
         "scenarios": np.array(["none", "gradual", "abrupt"]),
         "batch_epochs": 4, "batch_size": 256, "speed_epochs": 6,
         "speed_batch_size": 64, "batch_key": 0, "run_key": 1}
ATOL = 1e-5


def _flatten(prefix, tree, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(f"{prefix}/{k}", v, out)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)


def _host(tree):
    """A reference params tree (a ``FleetParamView`` too) as numpy."""
    return jax.tree_util.tree_map(np.asarray, tree)


def reference_draws(single, data, key):
    """The init params and the (epochs*steps, batch) permutation indices
    the reference's fleet fit draws for one stream from ``key``, as its
    ``_fit_group`` and epoch scan derive them (one ``split``, then the
    init from the first half and the epochs' permutations from the
    second); the indices as int16."""
    nb = ref_bucket_examples(len(data["x"]), single.batch_size)
    init_key, perm_key = jax.random.split(key)
    perms = jax.vmap(lambda k: jax.random.permutation(k, nb))(
        jax.random.split(perm_key, single.epochs))
    idx = np.asarray(perms).reshape(-1, single.batch_size)
    assert idx.max() < np.iinfo(np.int16).max
    return _host(single._init_fn(init_key)), idx.astype(np.int16)


def build_fixture():
    """Run the reference's fleet ``smoke.FLEET_RUNS``' four ways and return
    the arrays: the setup, the shared batch model, every (stream, window)
    fit's draws (``init_{sid}_w{w}``, ``idx_{sid}_w{w}``), trained params
    (``fit_...``) and losses (``loss_...``), and each run's records
    (``records/{run}/{sid}``) and, gated, retrain logs."""
    s = SETUP
    cfg = get_config("lstm-paper")
    streams, hist0 = ref_fleet_streams(
        s["n_streams"], s["n_windows"], s["records_per_window"],
        list(s["scenarios"]), seed=s["seed"], hist_len=s["hist_len"],
        alphas=np.full(5, s["drift_alpha"]))
    ids = list(streams)
    bp, _ = ref_pretrain(ref_forecaster(cfg, epochs=s["batch_epochs"],
                                        batch_size=s["batch_size"]),
                         hist0, jax.random.PRNGKey(s["batch_key"]))
    run_key = jax.random.PRNGKey(s["run_key"])
    keymap = {tuple(np.asarray(k).tolist()): (sid, w)
              for sid, chain in ref_fleet_key_chains(
                  run_key, ids, s["n_windows"]).items()
              for w, k in enumerate(chain)}
    out = {f"fsetup/{k}": np.asarray(v) for k, v in s.items()}
    out["fsetup/ids"] = np.array(ids)
    _flatten("batch", _host(bp), out)
    for name, (bus, quantized, gated) in smoke.FLEET_RUNS.items():
        ff = ref_fleet_forecaster(cfg, epochs=s["speed_epochs"],
                                  batch_size=s["speed_batch_size"])
        train_fleet = ff.train_fleet

        def recording(datas, keys, ff=ff, train_fleet=train_fleet):
            params, wall = train_fleet(datas, keys)
            for d, k, p, losses in zip(datas, keys, params, ff.last_losses):
                sid, w = keymap[tuple(np.asarray(k).tolist())]
                if f"fit_{sid}_w{w}/lstm/kernel" not in out:
                    _flatten(f"fit_{sid}_w{w}", _host(p), out)
                    out[f"loss_{sid}_w{w}"] = np.asarray(losses)
                    init, idx = reference_draws(ff.single, d, k)
                    _flatten(f"init_{sid}_w{w}", init, out)
                    out[f"idx_{sid}_w{w}"] = idx
            return params, wall

        ff.train_fleet = recording
        stages = RefFleetStages.build(ff, mode="dynamic")
        gate = RefDriftGate() if gated else None
        if bus:
            ex = RefFleetBusExecutor(
                stages, ref_integrated(), ref_topology(),
                RefCostModel(ingest_s=smoke.BUS_INGEST_S), gate=gate,
                quantized_sync=quantized)
        else:
            ex = RefInProcessFleetExecutor(stages, gate=gate)
        res = ex.run(streams, bp, run_key)
        for sid in ids:
            out[f"records/{name}/{sid}"] = smoke.records_array(
                res.results[sid].records)
            if gated:
                out[f"retrain/{name}/{sid}"] = np.array(res.retrain_log[sid])
    return out


@pytest.fixture(scope="module")
def reference():
    return build_fixture()


@pytest.fixture(scope="module")
def single_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def replays(reference, single_thread):
    """The port's four runs from the reference's draws, on the CPU."""
    return {name: smoke.run_fleet_replay(reference, "cpu", name)
            for name in smoke.FLEET_RUNS}


def test_fixture_regenerates_from_jax(reference):
    """The committed fixture is what the JAX package produces now (records
    to rtol 1e-4, arrays to atol 1e-4: XLA's CPU code may differ in the
    last bits between machines)."""
    committed = smoke.load_fixture(smoke.FLEET_FIXTURE)
    assert sorted(reference) == sorted(committed)
    for k, v in reference.items():
        if k.startswith("records/"):
            np.testing.assert_array_equal(v[:, 0], committed[k][:, 0])
            np.testing.assert_allclose(v[:, 1:], committed[k][:, 1:],
                                       rtol=1e-4, atol=1e-7, err_msg=k)
        elif k.startswith(("fsetup/", "retrain/", "idx_")):
            np.testing.assert_array_equal(v, committed[k], err_msg=k)
        else:
            np.testing.assert_allclose(v, committed[k], rtol=0, atol=1e-4,
                                       err_msg=k)


def test_port_fleet_sources_match_reference():
    ours, hist_ours = smoke.fleet_data(
        smoke.unflatten({f"fsetup/{k}": np.asarray(v)
                         for k, v in SETUP.items()}, "fsetup"))
    ref, hist_ref = ref_fleet_streams(
        3, 4, 150, ["none", "gradual", "abrupt"], seed=0, hist_len=1200,
        alphas=np.full(5, 1.5e-3))
    assert list(ours) == list(ref)
    np.testing.assert_array_equal(hist_ours["x"], hist_ref["x"])
    for sid in ref:
        for t in range(4):
            for k in ("x", "y"):
                np.testing.assert_array_equal(ours[sid].supervised(t)[k],
                                              ref[sid].supervised(t)[k])


def test_port_fleet_fits_match_reference(reference, replays):
    """Every stacked fleet fit of the in-process run, from the reference's
    draws, equals the reference's ``train_fleet``: each stream's params and
    per-step loss trajectory to 1e-5."""
    _, fits, ff = replays["inproc"]
    assert len(fits) == 3 * 4
    assert smoke.check_fleet_fits(reference, fits, ATOL) < ATOL
    assert ff.train_dispatches == 4


@pytest.mark.parametrize("name", list(smoke.FLEET_RUNS))
def test_port_fleet_records_match_reference(reference, replays, name):
    """Every stream's records of each run equal the reference's (RMSEs
    rtol 1e-5, weights atol 1e-5), a gated run's retrain log exactly, and
    every fit it made (the bus's warm-up and the gated subsets too) the
    reference's to 1e-5."""
    res, fits, _ = replays[name]
    assert smoke.check_fleet_records(reference, name, res, rtol=ATOL,
                                     atol=ATOL) < ATOL
    smoke.check_fleet_fits(reference, fits, ATOL)
    for r in res.results.values():
        assert len(r.records) == 3


def test_fleet_bus_matches_inprocess(replays):
    """Under the bus (integrated), the fleet reproduces the in-process
    fleet's records exactly, trains one fleet fit a window, records every
    stream's end-to-end latency, and multiplexes per-stream topics."""
    sync, _, _ = replays["inproc"]
    bus, _, _ = replays["bus_float"]
    assert bus.train_dispatches == sync.train_dispatches == 4
    for sid in sync.results:
        for a, b in zip(sync.results[sid].records, bus.results[sid].records):
            assert (a.window, a.rmse_batch, a.rmse_speed, a.rmse_hybrid) == (
                b.window, b.rmse_batch, b.rmse_speed, b.rmse_hybrid)
        assert set(bus.e2e_s[sid]) == {1, 2, 3}
    topics = {m.topic for m in bus.message_log}
    models = [m for m in bus.message_log if m.topic.startswith(T_MODEL + "/")]
    assert len(models) == 4 * 3
    for sid in sync.results:
        assert f"{T_STREAM}/{sid}" in topics and f"{T_MODEL}/{sid}" in topics
    for m in models:
        assert m.topic == f"{T_MODEL}/{m.payload['stream']}"
        assert m.nbytes == smoke.FLOAT_MODEL_NBYTES
        assert m.payload["checksum"] == tree_checksum(m.payload["params"])
    assert bus.infer_dispatches == {"batch": {"ticks": 3, "dispatches": 3},
                                    "speed": {"ticks": 3, "dispatches": 3}}


def test_fleet_int8_sync_publishes(reference, replays):
    """Int8 sync: every publish is a ``QTensor`` tree of the int8 byte
    count, its q and scale bit for bit the reference's ``quantize_tree``
    of the same float params, and every window is served by an installed
    int8 model."""
    res, _, _ = replays["bus_int8"]
    models = [m for m in res.message_log
              if m.topic.startswith(T_MODEL + "/")]
    assert len(models) == 4 * 3
    for m in models:
        assert m.nbytes == smoke.INT8_MODEL_NBYTES
        p = m.payload["params"]
        assert isinstance(p["lstm"]["kernel"], QTensor)
    speed = [m for m in res.message_log
             if m.topic.startswith("results/speed/")]
    assert speed and not any(m.payload["fallback"] for m in speed)


def test_quantize_fleet_bit_for_bit(replays):
    """``quantize_fleet`` over a stacked fit's views gives, bit for bit,
    each stream's own ``quantize_tree`` and the reference's
    ``quantize_tree`` of the same numpy params."""
    _, fits, _ = replays["inproc"]
    views = [runs[0][0] for (_, w), runs in sorted(fits.items()) if w == 2]
    assert all(isinstance(v, FleetParamView) for v in views)
    fleet = quantize_fleet(views, min_size=64)
    for v, q in zip(views, fleet):
        one = quantize_tree(v, min_size=64)
        ref = ref_quantize_tree(
            jax.tree_util.tree_map(jax.numpy.asarray, v.host_tree()),
            min_size=64)
        for sub in one:
            for leaf in one[sub]:
                a, b, r = one[sub][leaf], q[sub][leaf], ref[sub][leaf]
                if isinstance(a, QTensor):
                    assert isinstance(r, RefQTensor)
                    for x, y, z in ((a.q, b.q, r.q),
                                    (a.scale, b.scale, r.scale)):
                        assert torch.equal(x, y)
                        np.testing.assert_array_equal(x.numpy(),
                                                      np.asarray(z))
                else:
                    assert torch.equal(a, b)
        assert tree_checksum(q) == tree_checksum(one)
        assert tree_nbytes(q) == smoke.INT8_MODEL_NBYTES


# ---------------------------------------------------------------------------
# the fleet fit on the port: sequential parity, padding, delegation
# ---------------------------------------------------------------------------


def _window(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, 5, 5)).astype(np.float32)
    y = x[:, :, 0].mean(axis=1, keepdims=True).astype(np.float32)
    return {"x": x, "y": y}


@pytest.fixture(scope="module")
def model():
    return get_model(port_config("lstm-paper"))


def _max_diff(a, b):
    return max(float((x - y).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_fleet_fit_matches_sequential(model, single_thread):
    """One stacked fit of 5 streams (bucket 8: three padded slots) equals 5
    sequential ``CompiledForecaster.train`` fits with the same keys, params
    and loss trajectories; a second window of the same shapes allocates no
    staging buffer."""
    S = 5
    datas = [_window(150, seed=i) for i in range(S)]
    keys = [11 + i for i in range(S)]
    ff = FleetForecaster(model, epochs=2, batch_size=64, device="cpu")
    params, wall = ff.train_fleet(datas, keys)
    assert wall > 0 and ff.train_dispatches == 1
    assert params[0].owner.dim() == bucket_streams(S) == 8
    for i in range(S):
        fc = CompiledForecaster(model, epochs=2, batch_size=64, device="cpu")
        seq, _ = fc.train(datas[i], None, keys[i])
        assert _max_diff(seq, params[i]) <= 1e-6
        np.testing.assert_allclose(ff.last_losses[i], fc.last_losses,
                                   rtol=0, atol=1e-6)
    allocs = ff.staging_allocs
    ff.train_fleet([_window(150, seed=100 + i) for i in range(S)], keys)
    assert ff.train_dispatches == 2 and ff.staging_allocs == allocs


def test_fleet_step_gradients_are_per_stream(model):
    """Each stream's gradient in a fleet step (the gradient of the sum of
    the per-stream losses) equals its single-stream gradient to 1e-6, and a
    padded slot's (all-zero mask) is exactly zero."""
    S, B = 3, 16
    trees = [model.init(torch.Generator().manual_seed(i), "cpu")
             for i in range(S)]
    stacked = {k: {kk: torch.stack([t[k][kk] for t in trees])
                   .requires_grad_(True) for kk in trees[0][k]}
               for k in trees[0]}
    batches = [_window(B, seed=20 + i) for i in range(S)]
    batch = {"x": torch.as_tensor(np.stack([b["x"] for b in batches])),
             "y": torch.as_tensor(np.stack([b["y"] for b in batches])),
             "mask": torch.ones((S, B))}
    batch["mask"][2] = 0  # the last stream a padded slot
    loss, _ = model.loss_fn(stacked, batch)
    assert tuple(loss.shape) == (S,) and float(loss[2].detach()) == 0.0
    grads = torch.autograd.grad(loss.sum(), tree_leaves(stacked))
    assert all(not bool(g[2].abs().sum()) for g in grads)
    for s in range(2):
        live = {k: {kk: v.detach()[s].clone().requires_grad_(True)
                    for kk, v in sub.items()} for k, sub in stacked.items()}
        one, _ = model.loss_fn(live, {
            "x": batch["x"][s], "y": batch["y"][s],
            "mask": batch["mask"][s]})
        g1 = torch.autograd.grad(one, tree_leaves(live))
        for a, b in zip(grads, g1):
            torch.testing.assert_close(a[s], b, rtol=0, atol=1e-6)


def test_fleet_padded_slots_no_leak(model, single_thread):
    """S = 33 at tiny shapes buckets to 64, 31 padded slots: one fit, the
    padded slots' params never move, and sampled streams equal their
    sequential fits."""
    S = 33
    datas = [_window(8, seed=i) for i in range(S)]
    keys = [1000 + i for i in range(S)]
    ff = FleetForecaster(model, epochs=1, batch_size=8, device="cpu")
    params, _ = ff.train_fleet(datas, keys)
    assert ff.train_dispatches == 1
    owner = params[0].owner
    assert owner.dim() == 64
    init0, _ = ff.draws(datas[0], keys[0])
    for leaf, start in zip(tree_leaves(owner.stacked), tree_leaves(init0)):
        assert torch.equal(leaf[S:], start.expand_as(leaf[S:]))
    for i in (0, S // 2, S - 1):
        fc = CompiledForecaster(model, epochs=1, batch_size=8, device="cpu")
        seq, _ = fc.train(datas[i], None, keys[i])
        assert _max_diff(seq, params[i]) <= 1e-6


def test_fleet_single_stream_delegates_byte_identical(model):
    data, key = _window(150), 3
    ff = FleetForecaster(model, epochs=3, batch_size=64, device="cpu")
    (fleet_p,), _ = ff.train_fleet([data], [key])
    seq, _ = CompiledForecaster(model, epochs=3, batch_size=64,
                                device="cpu").train(data, None, key)
    assert not isinstance(fleet_p, FleetParamView)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(seq),
                                                 tree_leaves(fleet_p)))
    assert ff.staging_allocs == 0  # no stacked buffer was ever staged


@pytest.mark.parametrize("S", [1, 2])
def test_fit_fleet_window_leaves_inits_untouched(model, S):
    """A group of one (delegated) and a stacked group both train copies of
    the caller's init tensors."""
    datas = [_window(8, seed=i) for i in range(S)]
    ff = FleetForecaster(model, epochs=1, batch_size=8, device="cpu")
    draws = [ff.draws(d, 40 + i) for i, d in enumerate(datas)]
    inits = [d[0] for d in draws]
    before = [[leaf.clone() for leaf in tree_leaves(t)] for t in inits]
    out = ff.fit_fleet_window(datas, inits, [d[1] for d in draws])
    for t, kept, fit in zip(inits, before, out):
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(t), kept))
        assert not all(torch.equal(a, b)
                       for a, b in zip(tree_leaves(fit), kept))


def test_bucket_streams():
    assert [bucket_streams(s) for s in (1, 2, 3, 8, 9, 100, 512, 1000,
                                        1024, 1025)] == [
        1, 2, 4, 8, 16, 128, 512, 1024, 1024, 2048]
    assert len({bucket_streams(s) for s in range(1, 1025)}) == 11
    with pytest.raises(ValueError):
        bucket_streams(0)


def test_resolve_fleet_params_shared_per_stream_and_partial():
    ids = ["t00", "t01"]
    shared = {"lstm": {"kernel": np.zeros(3)}}
    out = resolve_fleet_params(shared, ids)
    assert out["t00"] is shared and out["t01"] is shared
    per = {"t00": {"a": 1}, "t01": {"a": 2}, "t02": {"a": 3}}
    assert resolve_fleet_params(per, ids) == {"t00": {"a": 1},
                                              "t01": {"a": 2}}
    with pytest.raises(ValueError, match="missing streams.*t01"):
        resolve_fleet_params({"t00": {"a": 1}}, ids)


@pytest.fixture(scope="module")
def fleet_fc():
    return lstm_fleet_forecaster(port_config("lstm-paper"), epochs=2,
                                 batch_size=64, device="cpu")


def test_predict_fleet_matches_single_predicts(fleet_fc):
    """One stacked predict serves every stream's ragged batch under its own
    params (float, and int8 trees through the int8 kernel's stream axis),
    equal to the single predicts; the fit's views serve their stacked tree
    as it is, and a one-stream call is the single predict."""
    ff = fleet_fc
    S = 3
    params, _ = ff.train_fleet([_window(150, seed=i) for i in range(S)],
                               [40 + i for i in range(S)])
    assert ff._stack_fleet_params(params, 4) is params[0].owner.stacked
    xs = [_window(n, seed=10 + n)["x"] for n in (100, 150, 37)]
    for trees in (params, quantize_fleet(params, min_size=64)):
        d0 = ff.predict_dispatches
        preds = ff.predict_fleet(trees, xs)
        assert ff.predict_dispatches - d0 == 1 and len(preds) == S
        for i in range(S):
            assert preds[i].shape == (len(xs[i]), 1)
            np.testing.assert_allclose(
                preds[i], ff.single.predict(trees[i], xs[i]), rtol=0,
                atol=1e-6)
    (p1,) = ff.predict_fleet([params[0]], [xs[0]])
    np.testing.assert_array_equal(p1, ff.single.predict(params[0], xs[0]))
    allocs = ff.staging_allocs
    ff.predict_fleet(params, xs)
    assert ff.staging_allocs == allocs


# ---------------------------------------------------------------------------
# the fleet executors on the port: placement, gating, refresh, robustness
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_fleet(single_thread):
    """The 3-stream fleet and a batch model pretrained by the port."""
    streams, hist0 = fleet_windowed_streams(
        3, 4, 150, ["none", "gradual", "abrupt"], seed=0, hist_len=1200,
        alphas=np.full(5, 1.5e-3))
    cfg = port_config("lstm-paper")
    bp, _ = pretrain_batch_model(
        lstm_forecaster(cfg, epochs=2, batch_size=256, device="cpu"),
        hist0, 0)
    return streams, bp


def _stages(mode="dynamic", epochs=3):
    ff = lstm_fleet_forecaster(port_config("lstm-paper"), epochs=epochs,
                               batch_size=64, device="cpu")
    return FleetStages.build(ff, mode=mode), ff


def test_fleet_bus_edge_centric_oom_degrades_all_streams(port_fleet):
    streams, bp = port_fleet
    stages, _ = _stages()
    res = FleetBusExecutor(stages, edge_centric(), paper_topology(),
                           CostModel(ingest_s=0.5)).run(streams, bp, 1)
    assert res.failures and "OOM" in res.failures[0]
    assert res.train_dispatches == 0
    for sid in streams:
        for r in res.results[sid].records:
            assert r.rmse_speed == r.rmse_batch


def test_gated_bus_skips_stationary_streams(single_thread):
    """A gated fleet of a stationary and a drifting stream: the stationary
    one skips retrains and keeps serving, skipped windows publish no model
    and keep t_speed_train 0, and the gate's stats agree with the retrain
    log."""
    streams, hist0 = fleet_windowed_streams(
        2, 6, 150, ["none", "abrupt"], seed=3, hist_len=1200)
    cfg = port_config("lstm-paper")
    bp, _ = pretrain_batch_model(
        lstm_forecaster(cfg, epochs=2, batch_size=256, device="cpu"),
        hist0, 0)
    stages, _ = _stages(epochs=2)
    res = FleetBusExecutor(stages, edge_cloud_integrated(), paper_topology(),
                           CostModel(ingest_s=0.5),
                           gate=DriftGate()).run(streams, bp, 1)
    assert res.skipped_retrains() > 0
    assert res.gate_stats["per_stream"]["t00"]["skipped"] > 0
    for sid in streams:
        assert len(res.results[sid].records) == 5
        for r in res.results[sid].records:
            if not res.retrain_log[sid][r.window]:
                assert r.t_speed_train == 0.0
    models = [m for m in res.message_log
              if m.topic.startswith(T_MODEL + "/")]
    assert len(models) == res.total_retrains()
    assert res.gate_stats["retrained"] == res.total_retrains()
    assert res.gate_stats["skipped"] == res.skipped_retrains()


def test_gated_inprocess_serves_prior_model_on_skip(port_fleet):
    streams, bp = port_fleet
    stages, _ = _stages()
    res = InProcessFleetExecutor(stages, gate=DriftGate()).run(streams, bp, 1)
    skipped = [sid for sid, log in res.retrain_log.items() if not all(log)]
    assert skipped
    for sid in skipped:
        for r in res.results[sid].records:
            assert r.rmse_speed != r.rmse_batch


def test_batch_refresh_rides_fleet_dispatch(port_fleet):
    """Gated run with a ``BatchRefresh``: archived windows retrain batch
    models in fleet fits on the cadence, counted apart from speed training,
    and a second run of the executor reproduces it exactly."""
    streams, bp = port_fleet
    stages, ff = _stages()
    rf = BatchRefresh(ff, every=2, min_windows=1, max_windows=4)
    ex = InProcessFleetExecutor(stages, gate=DriftGate(), batch_refresh=rf)
    res = ex.run(streams, bp, 1)
    assert res.refresh["rounds"] >= 1 and res.refresh["dispatches"] >= 1
    assert res.refresh["refreshed"]
    assert res.train_dispatches <= res.n_windows
    for sid in res.refresh["refreshed"]:
        assert sum(res.retrain_log[sid]) >= rf.min_windows
    res2 = ex.run(streams, bp, 1)
    assert res2.refresh["refreshed"] == res.refresh["refreshed"]
    assert res2.retrain_log == res.retrain_log


def test_batch_refresh_updates_batch_params(port_fleet):
    """After a refresh round the refreshed stream's batch RMSE changes on
    later windows; without one the pretrained batch model serves
    throughout."""
    streams, bp = port_fleet
    stages_a, _ = _stages()
    base = InProcessFleetExecutor(stages_a).run(streams, bp, 9)
    stages_b, ffb = _stages()
    rf = BatchRefresh(ffb, every=2, min_windows=2, max_windows=4)
    ref = InProcessFleetExecutor(stages_b, batch_refresh=rf).run(
        streams, bp, 9)
    assert ref.refresh["rounds"] >= 1
    changed = any(a.rmse_batch != b.rmse_batch
                  for sid in ref.refresh["refreshed"]
                  for a, b in zip(base.results[sid].records,
                                  ref.results[sid].records))
    assert changed


def _bus(port_fleet, **kw):
    streams, bp = port_fleet
    stages, _ = _stages()
    ex = FleetBusExecutor(stages, edge_cloud_integrated(), paper_topology(),
                          CostModel(ingest_s=0.5), **kw)
    ex._reset(list(streams))
    ex._bp = resolve_fleet_params(bp, list(streams))
    return ex, streams


def test_model_sync_rejects_corrupt_publish_and_resyncs(port_fleet):
    """A publish whose checksum fails is never installed; the sync site
    re-requests it (at most ``max_resync`` times) and the training site
    re-sends its last publish, which installs."""
    ex, streams = _bus(port_fleet, max_resync=1)
    sid = "t01"
    params = ex._bp[sid]
    good = {"stream": sid, "window": 2, "params": params,
            "eval_preds": None, "eval_y": None,
            "checksum": tree_checksum(params)}
    ex._last_model_pub[sid] = (good, 31_124.0)
    ex.bus.publish(f"{T_MODEL}/{sid}", {**good, "checksum": 1}, 31_124.0,
                   "cloud")
    ex.kernel.run()
    assert ex._fleet.state(sid).window == 2
    assert ex._fleet.state(sid).speed_params is params
    assert ex._resync_sent == {(sid, 2): 1}
    assert [m.topic for m in ex.bus.log].count(f"{T_RESYNC}/{sid}") == 1
    assert ex.stages.single.model_sync.corrupt_rejected == 1


def test_flush_dispatches_arrivals_and_quarantines(port_fleet):
    """The aggregation timeout dispatches the streams that arrived, and a
    stream that missed ``quarantine_after`` training flushes is
    quarantined until it delivers again."""
    ex, streams = _bus(port_fleet, quarantine_after=2)
    ex._keys = {sid: list(range(1, 5)) for sid in streams}
    seen = []
    ex._dispatch_train = lambda w, pend: seen.append((w, sorted(pend)))
    for w in (0, 1):
        for sid in ("t00", "t01"):
            data = streams[sid].supervised(w)
            msg = types.SimpleNamespace(payload={
                "stream": sid, "window": w, "x": data["x"],
                "y": data["y"]})
            assert ex._gather("train", msg) is None
        ex._flush("train", w)
    assert seen == [(0, ["t00", "t01"]), (1, ["t00", "t01"])]
    assert ex._quarantined == {"t02": 1}
    data = streams["t00"].supervised(2)
    for sid in ("t00", "t01"):
        msg = types.SimpleNamespace(payload={
            "stream": sid, "window": 2, "x": data["x"], "y": data["y"]})
        got = ex._gather("train", msg)
    assert sorted(got) == ["t00", "t01"]  # no longer waiting for t02


def test_staleness_watchdog_serves_batch_fallback(port_fleet):
    ex, streams = _bus(port_fleet, staleness_bound=1)
    for sid, w in (("t00", 3), ("t01", 1)):
        st = ex._fleet.state(sid)
        st.speed_params, st.window = {"marker": sid}, w
    params, windows, fallback = ex._serving_params(
        {"t00": 3, "t01": 3, "t02": 3})
    assert fallback == {"t00": False, "t01": True, "t02": True}
    assert params[0] == {"marker": "t00"} and params[1] is ex._bp["t01"]
    assert windows == {"t00": 3, "t01": 1, "t02": -1}


def test_handoff_copies_a_view(fleet_fc):
    params, _ = fleet_fc.train_fleet(
        [_window(150, seed=i) for i in range(2)], [1, 2])
    fleet = FleetState()
    st = fleet.state("a")
    st.speed_params = params[1]
    nbytes = fleet.handoff("a")
    assert nbytes == smoke.FLOAT_MODEL_NBYTES
    assert isinstance(st.speed_params, dict)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(st.speed_params), tree_leaves(params[1])))
    assert st.speed_params["lstm"]["kernel"].data_ptr() != \
        params[1]["lstm"]["kernel"].data_ptr()


def test_fleet_entry_points_need_a_device(monkeypatch):
    """Without CUDA and with no device named, the fleet's entry points
    raise rather than carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        lstm_fleet_forecaster(port_config("lstm-paper"), epochs=1,
                              batch_size=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        FleetForecaster(get_model(port_config("lstm-paper")), epochs=1,
                        batch_size=8)


def test_fleet_fit_from_host_draws(model):
    """``fit_fleet_window`` takes numpy draws as the reference's fixture
    holds them, and equals ``train_fleet`` from the same draws."""
    datas = [_window(150, seed=i) for i in range(3)]
    ff = FleetForecaster(model, epochs=1, batch_size=64, device="cpu")
    draws = [ff.draws(d, 7 + i) for i, d in enumerate(datas)]
    a = ff.fit_fleet_window(
        datas, [{k: {kk: v.numpy() for kk, v in sub.items()}
                 for k, sub in init.items()} for init, _ in draws],
        [idx.numpy().astype(np.int16) for _, idx in draws])
    b, _ = ff.train_fleet(datas, [7, 8, 9])
    for x, y in zip(a, b):
        assert _max_diff(x, y) == 0.0
    with pytest.raises(ValueError, match="3 windows, 2 inits"):
        ff.fit_fleet_window(datas, [draws[0][0]] * 2, [draws[0][1]] * 3)


if __name__ == "__main__":
    smoke.FLEET_FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(smoke.FLEET_FIXTURE, **build_fixture())
    print(f"wrote {smoke.FLEET_FIXTURE} "
          f"({smoke.FLEET_FIXTURE.stat().st_size} bytes)")
