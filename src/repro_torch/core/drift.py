"""Concept drift: stationarity testing and drift detection.  A copy of the
reference's numpy-only ``src/repro/core/drift.py``, so the port gates its
fleet's retraining on the same statistics, bit for bit.

* ``adf_test`` — augmented Dickey-Fuller test (the paper applies it to each
  turbine channel, Sec. 6.1.1) implemented from scratch on numpy lstsq, with
  MacKinnon (1994/2010) approximate p-values for the constant-only case.

* ``PageHinkleyDetector`` / ``window_mean_shift`` — lightweight online drift
  detectors feeding the runtime's drift-gated retraining.

* ``DriftGate`` — the per-stream retraining policy built on them: the fleet
  executors consult it once per (stream, window) at training time, and only
  drifting streams pay a retrain — stationary streams keep serving their
  prior speed model (beyond-paper extension; the paper re-trains every
  window regardless).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# MacKinnon approximate critical values (constant, no trend), 1/5/10 %
ADF_CRIT = {-1: None, 1: -3.43, 5: -2.86, 10: -2.57}

# MacKinnon (2010) response-surface coefficients for p-value interpolation
# (constant only).  tau -> p via a logistic fit on tabulated points.
_TAU_TABLE = np.array(
    [-6.0, -5.0, -4.5, -4.0, -3.6, -3.43, -3.2, -3.0, -2.86, -2.57, -2.2,
     -1.9, -1.6, -1.2, -0.8, -0.4, 0.0, 0.5, 1.0, 2.0]
)
_P_TABLE = np.array(
    [1e-8, 5e-6, 5e-5, 4e-4, 2e-3, 5e-3, 1.5e-2, 3e-2, 5e-2, 1e-1, 2e-1,
     3e-1, 4.4e-1, 5.9e-1, 7.3e-1, 8.4e-1, 9.1e-1, 9.6e-1, 9.85e-1, 9.99e-1]
)


def mackinnon_pvalue(tau: float) -> float:
    """Approximate ADF p-value (constant only) by interpolation on the
    MacKinnon table.  ``tau`` beyond either table end clamps to the end
    value (``np.interp`` semantics): more negative than -6.0 -> 1e-8, more
    positive than +2.0 -> 0.999 — adequate for reject/fail-to-reject use,
    and monotone non-decreasing in tau by construction."""
    return float(np.interp(tau, _TAU_TABLE, _P_TABLE))


@dataclass(frozen=True)
class ADFResult:
    statistic: float
    pvalue: float
    n_lags: int
    stationary_5pct: bool


def adf_test(y: np.ndarray, max_lag: Optional[int] = None) -> ADFResult:
    """ADF with constant; lag order by Schwert rule, p-value by interpolation
    on the MacKinnon table (adequate for the paper's reject/fail-to-reject
    usage; exact statsmodels values differ in the 3rd decimal)."""
    y = np.asarray(y, np.float64).ravel()
    n = len(y)
    if max_lag is None:
        max_lag = int(np.floor(12.0 * (n / 100.0) ** 0.25))
        max_lag = min(max_lag, n // 2 - 2)
    dy = np.diff(y)
    k = max_lag
    # regression: dy_t = c + rho*y_{t-1} + sum_i g_i dy_{t-i}
    T = len(dy) - k
    X = [np.ones(T), y[k:-1]]
    for i in range(1, k + 1):
        X.append(dy[k - i : len(dy) - i])
    X = np.stack(X, axis=1)
    target = dy[k:]
    beta, *_ = np.linalg.lstsq(X, target, rcond=None)
    resid = target - X @ beta
    dof = max(T - X.shape[1], 1)
    sigma2 = resid @ resid / dof
    cov = sigma2 * np.linalg.pinv(X.T @ X)
    se_rho = np.sqrt(max(cov[1, 1], 1e-300))
    tau = float(beta[1] / se_rho)
    p = mackinnon_pvalue(tau)
    return ADFResult(statistic=tau, pvalue=p, n_lags=k,
                     stationary_5pct=tau < ADF_CRIT[5])


@dataclass
class PageHinkleyDetector:
    """Page-Hinkley mean-shift detector over a scalar stream (e.g. per-window
    RMSE): alarm when the cumulative deviation exceeds ``threshold``."""

    delta: float = 0.005
    threshold: float = 0.2
    alpha: float = 0.999
    _mean: float = 0.0
    _cum: float = 0.0
    _min_cum: float = 0.0
    n: int = 0
    alarms: int = 0

    def update(self, x: float) -> bool:
        self.n += 1
        self._mean += (x - self._mean) / self.n
        self._cum = self.alpha * self._cum + (x - self._mean - self.delta)
        self._min_cum = min(self._min_cum, self._cum)
        if self._cum - self._min_cum > self.threshold:
            self.alarms += 1
            self._cum = 0.0
            self._min_cum = 0.0
            return True
        return False


def window_mean_shift(prev: np.ndarray, cur: np.ndarray, z: float = 3.0) -> bool:
    """Two-window mean-shift check (z-test on window means)."""
    prev = np.asarray(prev, np.float64).ravel()
    cur = np.asarray(cur, np.float64).ravel()
    se = np.sqrt(prev.var() / max(len(prev), 1) + cur.var() / max(len(cur), 1))
    if se == 0:
        return False
    return bool(abs(cur.mean() - prev.mean()) / se > z)


# ---------------------------------------------------------------------------
# Drift-gated retraining policy
# ---------------------------------------------------------------------------


@dataclass
class _GateState:
    """One stream's gate state: the reference window (what the serving
    speed model last trained on) and a Page-Hinkley detector over the
    window means observed since that retrain."""

    ph: PageHinkleyDetector
    ref: Optional[np.ndarray] = None
    seen: int = 0
    retrained: int = 0
    skipped: int = 0
    log: List[bool] = field(default_factory=list)


@dataclass
class DriftGate:
    """Per-stream drift-gated retraining: decide, at training time, whether
    a stream's window is worth a speed-model retrain.

    ``decide(sid, y)`` is called once per (stream, window) with the window's
    supervised targets and returns True (retrain) when either detector
    fires:

    * ``window_mean_shift`` z-test of this window against the *reference*
      window — the one the serving model last trained on — so abrupt jumps
      fire immediately and gradual drift fires once it has accumulated past
      the threshold relative to the model's training distribution;
    * ``PageHinkleyDetector`` over the sequence of window means since the
      last retrain — the cumulative test that catches slow drift the
      two-window z-test under-powers.

    The first ``warmup`` windows of every stream always retrain (a model
    must exist, and the detectors need a baseline).  On retrain the
    reference window and the PH state reset: the gate always measures drift
    *since the stream's last retrain*, so a stationary stream settles into
    skipping every window while a drifting one keeps firing.

    ``z`` defaults well above the textbook 3.0 because the turbine channels
    are strongly autocorrelated within a window — the iid standard error
    underestimates the window-mean wander of a perfectly stationary stream,
    so a small ``z`` would retrain on noise.
    """

    z: float = 8.0
    ph_delta: float = 0.005
    ph_threshold: float = 0.1
    warmup: int = 1
    _streams: Dict[str, _GateState] = field(default_factory=dict)

    def _state(self, sid: str) -> _GateState:
        st = self._streams.get(sid)
        if st is None:
            st = self._streams[sid] = _GateState(ph=self._new_ph())
        return st

    def _new_ph(self) -> PageHinkleyDetector:
        return PageHinkleyDetector(delta=self.ph_delta,
                                   threshold=self.ph_threshold)

    def decide(self, sid: str, y: np.ndarray) -> bool:
        """True -> retrain the stream on this window; False -> skip (the
        stream keeps serving its prior speed model)."""
        st = self._state(sid)
        st.seen += 1
        y = np.asarray(y, np.float64).ravel()
        if st.ref is None or st.seen <= self.warmup:
            fire = True
        else:
            fire = (window_mean_shift(st.ref, y, z=self.z)
                    or st.ph.update(float(y.mean())))
        self._record(st, y, fire)
        return fire

    def force_retrain(self, sid: str, y: np.ndarray) -> None:
        """Record a retrain the executor forced regardless of drift (e.g.
        the stream has no serving model yet because a publish is still in
        flight), so the reference window tracks what the model actually
        trained on and the stats stay consistent with the executor's
        retrain log."""
        st = self._state(sid)
        st.seen += 1
        self._record(st, np.asarray(y, np.float64).ravel(), True)

    def _record(self, st: _GateState, y: np.ndarray, fire: bool) -> None:
        if fire:
            st.retrained += 1
            st.ref = y
            st.ph = self._new_ph()
        else:
            st.skipped += 1
        st.log.append(fire)

    # -- introspection -------------------------------------------------------

    def retrain_log(self) -> Dict[str, List[bool]]:
        return {sid: list(st.log) for sid, st in self._streams.items()}

    def stats(self) -> Dict[str, object]:
        per_stream = {
            sid: {"retrained": st.retrained, "skipped": st.skipped}
            for sid, st in self._streams.items()
        }
        return {
            "retrained": sum(st.retrained for st in self._streams.values()),
            "skipped": sum(st.skipped for st in self._streams.values()),
            "per_stream": per_stream,
        }
