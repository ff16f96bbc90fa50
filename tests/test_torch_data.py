"""The port's numpy-side modules (sources, scaling, windows, weighting) agree
with the reference's on the same seeds."""
import numpy as np
import pytest

from repro.core import weighting as w_ref
from repro.core import windows as win_ref
from repro.streams import normalize as norm_ref
from repro.streams import sources as src_ref
from repro_torch.core import weighting as w_t
from repro_torch.core import windows as win_t
from repro_torch.streams import normalize as norm_t
from repro_torch.streams import sources as src_t


@pytest.mark.parametrize("seed", [0, 7])
def test_wind_turbine_series_identical(seed):
    np.testing.assert_array_equal(src_t.wind_turbine_series(600, seed=seed),
                                  src_ref.wind_turbine_series(600, seed=seed))


@pytest.mark.parametrize("scenario", ["none", "gradual", "abrupt", "seasonal"])
def test_drift_scenarios_identical(scenario):
    base = src_ref.wind_turbine_series(400, seed=3)
    kw = dict(seed=5, alphas=None, start=100)
    np.testing.assert_array_equal(
        src_t.apply_scenario(base, scenario, **kw),
        src_ref.apply_scenario(base, scenario, **kw))


def test_scaler_identical():
    x = src_ref.wind_turbine_series(300, seed=1)
    a, b = norm_t.MinMaxScaler.fit(x), norm_ref.MinMaxScaler.fit(x)
    np.testing.assert_array_equal(a.lo, b.lo)
    np.testing.assert_array_equal(a.hi, b.hi)
    np.testing.assert_array_equal(a.transform(x), b.transform(x))
    np.testing.assert_array_equal(a.inverse(a.transform(x)),
                                  b.inverse(b.transform(x)))
    np.testing.assert_array_equal(a.inverse(x[:, 2], col=2),
                                  b.inverse(x[:, 2], col=2))


@pytest.mark.parametrize("lag", [1, 5])
def test_windows_identical(lag):
    series = src_ref.wind_turbine_series(1000, seed=2)
    for n in (0, lag, 37):
        a, b = win_t.make_supervised(series[:n], lag), win_ref.make_supervised(
            series[:n], lag)
        np.testing.assert_array_equal(a["x"], b["x"])
        np.testing.assert_array_equal(a["y"], b["y"])
    plan_t = win_t.WindowPlan(n_windows=5, records_per_window=150, lag=lag)
    plan_r = win_ref.WindowPlan(n_windows=5, records_per_window=150, lag=lag)
    ws_t, ws_r = win_t.WindowedStream(series, plan_t), win_ref.WindowedStream(
        series, plan_r)
    assert len(ws_t) == len(ws_r)
    for (ta, ra, da), (tb, rb, db) in zip(ws_t, ws_r):
        assert ta == tb
        np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(da["x"], db["x"])
        np.testing.assert_array_equal(da["y"], db["y"])


def _preds(seed, n=250):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(n, 1)).astype(np.float32)
    ps = (y + rng.normal(scale=0.3, size=y.shape)).astype(np.float32)
    pb = (y + 0.2 + rng.normal(scale=0.2, size=y.shape)).astype(np.float32)
    return ps, pb, y


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_weighting_identical(seed):
    ps, pb, y = _preds(seed)
    assert w_t.rmse(y, ps) == w_ref.rmse(y, ps)
    assert w_t.static_weights(0.3) == w_ref.static_weights(0.3)
    np.testing.assert_array_equal(w_t.combine([ps, pb], [0.3, 0.7]),
                                  w_ref.combine([ps, pb], [0.3, 0.7]))
    cf_t = w_t.dwa_closed_form(ps, pb, y)
    np.testing.assert_allclose(cf_t, w_ref.dwa_closed_form(ps, pb, y),
                               rtol=0, atol=1e-12)
    sp_t = w_t.dwa_scipy([ps, pb], y)
    np.testing.assert_allclose(sp_t, w_ref.dwa_scipy([ps, pb], y),
                               rtol=0, atol=1e-12)


def test_closed_form_clips_and_degenerates():
    ps, pb, y = _preds(3)
    assert w_t.dwa_closed_form(ps, pb, ps) == (1.0, 0.0)
    assert w_t.dwa_closed_form(ps, ps, y) == (0.5, 0.5)
    with pytest.raises(ValueError):
        w_t.static_weights(1.5)
