"""The port's drift layer and fleet sources held to the JAX package's,
exactly: ``core.drift`` (the ADF test and its p-values, Page-Hinkley, the
two-window mean shift, ``DriftGate``), ``turbine_fleet`` and
``fleet_windowed_streams``, on the same numpy inputs.  Then the fleet's
training-key chains (stream ``i``'s chain is a single-stream run's under
its root) and the fleet launcher on the CPU."""
import numpy as np
import pytest

from repro.core import drift as drift_ref
from repro.streams import sources as src_ref
from repro_torch.core import drift
from repro_torch.launch import edge_cloud
from repro_torch.runtime import (
    fleet_key_chains,
    refresh_key_chains,
    stream_roots,
    window_seeds,
)
from repro_torch.streams import sources


def _series(kind, seed, n=600):
    rng = np.random.default_rng(seed)
    if kind == "walk":
        return np.cumsum(rng.normal(0, 1, n))
    if kind == "turbine":
        return src_ref.wind_turbine_series(n, seed=seed)[:, seed % 5]
    return rng.normal(0, 1, n)


@pytest.mark.parametrize("kind", ["walk", "turbine", "noise"])
@pytest.mark.parametrize("max_lag", [None, 0, 3])
def test_adf_test_equals_reference(kind, max_lag):
    y = _series(kind, seed=len(kind))
    assert vars(drift.adf_test(y, max_lag)) == \
        vars(drift_ref.adf_test(y, max_lag))


def test_mackinnon_pvalue_equals_reference():
    for tau in np.linspace(-8.0, 3.0, 97):
        assert drift.mackinnon_pvalue(tau) == drift_ref.mackinnon_pvalue(tau)


def test_page_hinkley_and_mean_shift_equal_reference():
    rng = np.random.default_rng(4)
    xs = np.concatenate([rng.normal(0, 0.05, 200), rng.normal(0.4, 0.05, 80)])
    ours, ref = drift.PageHinkleyDetector(), drift_ref.PageHinkleyDetector()
    assert [ours.update(float(x)) for x in xs] == [ref.update(float(x))
                                                   for x in xs]
    assert vars(ours) == vars(ref) and ours.alarms > 0
    for z in (1.0, 3.0, 8.0):
        for a, b in ((xs[:100], xs[100:200]), (xs[:100], xs[200:]),
                     (np.ones(5), np.ones(5))):
            assert drift.window_mean_shift(a, b, z) == \
                drift_ref.window_mean_shift(a, b, z)


@pytest.mark.parametrize("scenarios", [["none", "abrupt"],
                                       ["gradual", "none", "abrupt"]])
def test_drift_gate_equals_reference(scenarios):
    """The same windows through both gates, forced retrains among them:
    every decision, the retrain log and the stats are equal."""
    streams, _ = src_ref.fleet_windowed_streams(
        len(scenarios), 8, 150, scenarios, seed=3, hist_len=600,
        alphas=np.full(5, 1.5e-3))
    ours, ref = drift.DriftGate(), drift_ref.DriftGate()
    for w in range(8):
        for i, (sid, ws) in enumerate(streams.items()):
            y = ws.supervised(w)["y"]
            if (w + i) % 5 == 0:
                ours.force_retrain(sid, y)
                ref.force_retrain(sid, y)
            else:
                assert ours.decide(sid, y) == ref.decide(sid, y)
    assert ours.retrain_log() == ref.retrain_log()
    assert ours.stats() == ref.stats()
    assert ours.stats()["skipped"] > 0


@pytest.mark.parametrize("scenarios,alphas,start", [
    ("none", None, 0), (["gradual", "abrupt", "none", "seasonal"], None, 50),
    (["abrupt", "gradual"], np.full(5, 1.5e-3), 0)])
def test_turbine_fleet_equals_reference(scenarios, alphas, start):
    n = 2 if isinstance(scenarios, list) and len(scenarios) == 2 else 4
    ours = sources.turbine_fleet(n, 400, seed=2, scenarios=scenarios,
                                 alphas=alphas, drift_start=start)
    ref = src_ref.turbine_fleet(n, 400, seed=2, scenarios=scenarios,
                                alphas=alphas, drift_start=start)
    assert list(ours) == list(ref)
    for sid in ref:
        assert ours[sid].dtype == ref[sid].dtype
        np.testing.assert_array_equal(ours[sid], ref[sid])
    with pytest.raises(ValueError, match="scenarios"):
        sources.turbine_fleet(3, 10, scenarios=["none"])


def test_fleet_windowed_streams_equal_reference():
    args = (3, 5, 120, ["none", "gradual", "abrupt"])
    kw = dict(seed=1, hist_len=700, alphas=np.full(5, 1.5e-3))
    ours, hist_ours = sources.fleet_windowed_streams(*args, **kw)
    ref, hist_ref = src_ref.fleet_windowed_streams(*args, **kw)
    assert list(ours) == list(ref) == ["t00", "t01", "t02"]
    for k in ("x", "y"):
        np.testing.assert_array_equal(hist_ours[k], hist_ref[k])
    for sid in ref:
        assert len(ours[sid]) == len(ref[sid]) == 5
        for t in range(5):
            for k in ("x", "y"):
                np.testing.assert_array_equal(ours[sid].supervised(t)[k],
                                              ref[sid].supervised(t)[k])


def test_fleet_key_chains_are_single_stream_chains():
    """Stream ``i``'s chain is exactly ``window_seeds`` of its root, the
    chain a single-stream run seeded with that root trains from; roots
    depend on the stream's index, not the fleet's size; explicit roots
    pass through; the refresh chains never meet the training keys."""
    ids = ["t00", "t01", "t02"]
    chains = fleet_key_chains(5, ids, 4)
    roots = stream_roots(5, 3)
    assert stream_roots(5, 8)[:3] == roots and len(set(roots)) == 3
    for sid, root in zip(ids, roots):
        assert chains[sid] == window_seeds(root, 4)
    assert fleet_key_chains(5, ids[:2], 4) == {k: chains[k] for k in ids[:2]}
    explicit = fleet_key_chains({"t00": 7, "t01": 9}, ["t00", "t01"], 3)
    assert explicit == {"t00": window_seeds(7, 3), "t01": window_seeds(9, 3)}
    refresh = refresh_key_chains(5, ids, 4)
    train = {k for chain in chains.values() for k in chain}
    assert not train & {k for chain in refresh.values() for k in chain}
    assert refresh_key_chains({"t00": 7}, ["t00"], 2)["t00"] != \
        window_seeds(7, 2)


def test_fleet_launcher_runs_gated_on_cpu(capsys):
    """``--real --streams 3 --gated`` on the CPU: every stream serves every
    inference window, one fleet fit a window at most, and the gate's
    decisions are printed."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        args = edge_cloud.parse_args(
            ["--real", "--streams", "3", "--gated", "--windows", "3",
             "--fast", "--deployment", "integrated"])
        runs = edge_cloud.run_real_fleet(args, device="cpu")
    finally:
        torch.set_num_threads(threads)
    res = runs["edge-cloud-integrated"]
    assert set(res.results) == {"t00", "t01", "t02"}
    assert all(len(r.records) == 2 for r in res.results.values())
    assert 1 <= res.train_dispatches <= 3
    assert res.total_retrains() + res.skipped_retrains() == 3 * 3
    out = capsys.readouterr().out
    assert "3 streams x 3 windows" in out and "gate: t00:" in out
