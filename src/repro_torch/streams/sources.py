"""Stream data sources (numpy), copied from the reference so the port draws
the same series from the same seeds.

* ``wind_turbine_series`` — a stationary 5-channel temperature-like series
  standing in for the ENGIE La Haute Borne turbine data the paper uses
  (Db1t_avg, Db2t_avg, Gb1t_avg, Gb2t_avg, Ot_avg; 10-minute cadence,
  ~50k observations).  Daily + seasonal harmonics, cross-correlated AR(1)
  noise, mean-reverting — ADF-stationary like the paper's (Sec. 6.1.1).

* ``gradual_drift`` / ``abrupt_drift`` — the paper's Eq. 6 / Eq. 7 drift
  simulators: GD_i(t) = a_i*t + Y_i(t) + eps;  AD_i(t) = a_i*t*lambda + Y_i(t)
  + eps with a random abrupt parameter lambda (piecewise-constant regime
  switches).  ``seasonal_drift`` extends the menu beyond the paper: a slow
  periodic component the history never saw, which drifts away and comes
  back.

* ``apply_scenario`` — name-keyed dispatch over the drift scenarios
  ({"none", "gradual", "abrupt"} from the paper's Sec. 6.1.3, plus
  "seasonal").

* ``turbine_fleet`` / ``fleet_windowed_streams`` — a fleet of correlated
  turbines, each on its own drift schedule, split into history and windowed
  live streams: the multi-stream entry points' data.

* ``token_stream`` — a Markov token stream whose transition matrix switches
  at ``drift_at``: the token source of the zoo's training examples.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np

N_TURBINE_CHANNELS = 5
CHANNEL_NAMES = ("Db1t_avg", "Db2t_avg", "Gb1t_avg", "Gb2t_avg", "Ot_avg")


def wind_turbine_series(
    n: int = 50_000, seed: int = 0, dt_minutes: float = 10.0
) -> np.ndarray:
    """(n, 5) float32 stationary series."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    day = 24 * 60 / dt_minutes  # samples per day
    year = 365 * day

    base_temp = np.array([45.0, 44.0, 55.0, 54.0, 12.0])  # bearing/gearbox/outdoor
    daily_amp = np.array([2.0, 2.2, 3.0, 2.8, 5.0])
    # mild seasonal term: strong enough to exist, weak enough that a model
    # trained on history stays competitive on the (stationary) stream — the
    # paper's no-drift scenario has batch ~ speed (Fig. 8a)
    seasonal_amp = np.array([1.2, 1.2, 1.6, 1.6, 3.0])
    noise_scale = np.array([0.8, 0.8, 1.2, 1.2, 1.5])

    daily = np.sin(2 * np.pi * t / day)[:, None] * daily_amp[None]
    seasonal = np.sin(2 * np.pi * t / year + 0.5)[:, None] * seasonal_amp[None]

    # cross-correlated AR(1) noise (shared ambient component)
    shared = np.zeros(n)
    eps_s = rng.normal(0, 0.3, n)
    for i in range(1, n):
        shared[i] = 0.98 * shared[i - 1] + eps_s[i]
    own = np.zeros((n, N_TURBINE_CHANNELS))
    eps_o = rng.normal(0, 1.0, (n, N_TURBINE_CHANNELS))
    for i in range(1, n):
        own[i] = 0.95 * own[i - 1] + eps_o[i]
    noise = (own + shared[:, None]) * noise_scale[None] * 0.5

    series = base_temp[None] + daily + seasonal + noise
    return series.astype(np.float32)


def gradual_drift(
    series: np.ndarray,
    alphas: Optional[np.ndarray] = None,
    eps_scale: float = 0.2,
    seed: int = 1,
    start: int = 0,
) -> np.ndarray:
    """Paper Eq. 6: GD_i(t) = alpha_i * t + Y_i(t) + eps (after ``start``)."""
    rng = np.random.default_rng(seed)
    n, f = series.shape
    if alphas is None:
        alphas = np.full(f, 5e-4)
    t = np.maximum(np.arange(n, dtype=np.float64) - start, 0.0)
    eps = rng.normal(0, eps_scale, (n, f))
    return (series + alphas[None] * t[:, None] + eps).astype(np.float32)


def abrupt_drift(
    series: np.ndarray,
    alphas: Optional[np.ndarray] = None,
    eps_scale: float = 0.2,
    seed: int = 2,
    n_switches: int = 4,
    start: int = 0,
) -> np.ndarray:
    """Paper Eq. 7: AD_i(t) = alpha_i * t * lambda + Y_i(t) + eps, with
    lambda a random abrupt parameter — piecewise-constant regime levels that
    switch at random change points (sudden concept switches)."""
    rng = np.random.default_rng(seed)
    n, f = series.shape
    if alphas is None:
        alphas = np.full(f, 8e-4)
    switch_points = np.sort(rng.choice(np.arange(start + 1, n - 1), n_switches,
                                       replace=False))
    lam = np.zeros(n)
    prev = 0
    levels = rng.uniform(-1.5, 1.5, n_switches + 1)
    for i, sp in enumerate(list(switch_points) + [n]):
        lam[prev:sp] = levels[i]
        prev = sp
    t = np.maximum(np.arange(n, dtype=np.float64) - start, 0.0)
    eps = rng.normal(0, eps_scale, (n, f))
    drift = alphas[None] * (t * lam)[:, None]
    return (series + drift + eps).astype(np.float32)


def seasonal_drift(
    series: np.ndarray,
    amp_scale: float = 1.0,
    period: Optional[int] = None,
    eps_scale: float = 0.2,
    seed: int = 3,
    start: int = 0,
) -> np.ndarray:
    """Seasonal drift: SD_i(t) = A_i * sin(2*pi*(t - start)/P + phi_i)
    + Y_i(t) + eps — a slow periodic component the history never saw, per
    channel with its own random phase.  Unlike Eq. 6's monotone ramp it
    drifts away and comes *back*.  ``period`` defaults to half the
    post-``start`` length (one full cycle over the live stream)."""
    rng = np.random.default_rng(seed)
    n, f = series.shape
    if period is None:
        period = max((n - start) // 2, 1)
    amps = amp_scale * series.std(axis=0)
    phases = rng.uniform(0.0, 2 * np.pi, f)
    t = np.maximum(np.arange(n, dtype=np.float64) - start, 0.0)
    wave = np.sin(2 * np.pi * t[:, None] / period + phases[None])
    # the drift only exists after start (wave(0) != 0 unless phi is 0)
    wave *= (t > 0)[:, None]
    eps = rng.normal(0, eps_scale, (n, f))
    return (series + amps[None] * wave + eps).astype(np.float32)


SCENARIOS = ("none", "gradual", "abrupt", "seasonal")


def apply_scenario(
    series: np.ndarray,
    scenario: str,
    seed: int = 1,
    alphas: Optional[np.ndarray] = None,
    start: int = 0,
) -> np.ndarray:
    """Apply one of the drift scenarios to a (stationary) series:
    ``"none"`` returns it untouched, ``"gradual"`` applies Eq. 6,
    ``"abrupt"`` applies Eq. 7, ``"seasonal"`` adds the periodic
    excursion-and-return component of :func:`seasonal_drift`."""
    if scenario == "none":
        return series
    if scenario == "gradual":
        return gradual_drift(series, alphas=alphas, seed=seed, start=start)
    if scenario == "abrupt":
        return abrupt_drift(series, alphas=alphas, seed=seed, start=start)
    if scenario == "seasonal":
        return seasonal_drift(series, seed=seed, start=start)
    raise ValueError(f"unknown scenario {scenario!r}; pick from {SCENARIOS}")


def turbine_fleet(
    n_streams: int,
    n: int,
    seed: int = 0,
    scenarios: Union[str, Sequence[str]] = "none",
    shared_frac: float = 0.35,
    alphas: Optional[np.ndarray] = None,
    drift_start: int = 0,
) -> Dict[str, np.ndarray]:
    """A fleet of N correlated turbines: ``{stream_id: (n, 5) series}``.

    Every turbine mixes a *shared* ambient component (the farm's common
    weather, weight ``shared_frac``) with its own independently-seeded
    series, so the streams are cross-correlated the way one site's turbines
    are.  ``scenarios`` is either one scenario name for the whole fleet or
    one per stream ({"none", "gradual", "abrupt"}), applied after the
    deviations-from-base mixing so each stream drifts (or doesn't) on its
    own schedule — the per-stream dynamic the drift-gated retraining policy
    exploits.

    Stream ids are ``"t00"``, ``"t01"``, ... (lexicographically ordered, so
    iteration order is deterministic)."""
    if isinstance(scenarios, str):
        scenarios = [scenarios] * n_streams
    if len(scenarios) != n_streams:
        raise ValueError(
            f"{n_streams} streams but {len(scenarios)} scenarios")
    shared = wind_turbine_series(n, seed=seed)
    shared_dev = shared - shared.mean(axis=0, keepdims=True)
    fleet: Dict[str, np.ndarray] = {}
    for i, scenario in enumerate(scenarios):
        own = wind_turbine_series(n, seed=seed + 1000 + i)
        mixed = (own + shared_frac * shared_dev).astype(np.float32)
        fleet[f"t{i:02d}"] = apply_scenario(
            mixed, scenario, seed=seed + 2000 + i, alphas=alphas,
            start=drift_start)
    return fleet


def fleet_windowed_streams(
    n_streams: int,
    n_windows: int,
    records_per_window: int,
    scenarios: Union[str, Sequence[str]] = "none",
    *,
    seed: int = 0,
    hist_len: int = 1600,
    alphas: Optional[np.ndarray] = None,
    lag: int = 5,
):
    """A :func:`turbine_fleet` split the way every fleet entrypoint consumes
    it: per stream, the first ``hist_len`` records are history, the rest is
    the windowed live stream, and each stream is min-max scaled by *its own*
    history.  Drift (when a stream's scenario has any) starts where the live
    stream does.

    Returns ``({stream_id: WindowedStream}, hist0_supervised)`` where
    ``hist0_supervised`` is the first stream's scaled history as supervised
    pairs — what the fleet's shared batch model pre-trains on.  Single
    source of truth for the launcher's ``--streams`` mode
    (``launch.edge_cloud.build_fleet_pipeline``) and the fleet tests."""
    from repro_torch.core.windows import (WindowedStream, WindowPlan,
                                         make_supervised)
    from repro_torch.streams.normalize import MinMaxScaler

    fleet_raw = turbine_fleet(
        n_streams, hist_len + records_per_window * n_windows + lag,
        seed=seed, scenarios=scenarios, alphas=alphas, drift_start=hist_len)
    streams, hist0 = {}, None
    for sid, series in fleet_raw.items():
        hist, tail = series[:hist_len], series[hist_len:]
        scaler = MinMaxScaler.fit(hist)
        if hist0 is None:
            hist0 = make_supervised(scaler.transform(hist), lag, 0)
        streams[sid] = WindowedStream(
            scaler.transform(tail),
            WindowPlan(n_windows, records_per_window, lag=lag))
    return streams, hist0


def token_stream(
    n: int, vocab: int, seed: int = 0, drift_at: Optional[int] = None
) -> np.ndarray:
    """Markov token stream; transition matrix switches at ``drift_at``."""
    rng = np.random.default_rng(seed)

    def trans(seed2):
        r = np.random.default_rng(seed2)
        m = r.dirichlet(np.full(vocab, 0.3), size=vocab)
        return m

    m1 = trans(seed)
    m2 = trans(seed + 1)
    out = np.zeros(n, np.int32)
    s = 0
    for i in range(1, n):
        m = m1 if (drift_at is None or i < drift_at) else m2
        s = rng.choice(vocab, p=m[s])
        out[i] = s
    return out
