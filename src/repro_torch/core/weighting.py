"""Weight-combination algorithms for the hybrid layer (paper Sec. 5.3).

``Pred_hybrid = W_s * Pred_speed + W_b * Pred_batch``, ``W_s + W_b = 1``.

* ``static_weights`` — fixed (W_s, W_b), the paper evaluates 3:7, 5:5, 7:3.

* ``dwa_scipy`` — the paper's Algorithm 1 verbatim: stack the batch model and
  the previous-window speed model, collect their predictions on the previous
  window's test set, and minimize RMSE with scipy SLSQP, init 0.5 each,
  bounds [0,1], constraint sum(W)=1.

* ``dwa_closed_form`` — the exact K=2 solution (clipped least squares on the
  simplex).

All of it runs on the host in numpy float64, as in the reference: the inputs
are one window's predictions.  The K>2 projected-gradient solver waits for a
slice whose path needs it.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
from scipy.optimize import minimize


def rmse(y: np.ndarray, pred: np.ndarray) -> float:
    """Paper Eq. 5."""
    y = np.asarray(y, np.float64).ravel()
    pred = np.asarray(pred, np.float64).ravel()
    return float(np.sqrt(np.mean((y - pred) ** 2)))


def static_weights(w_speed: float) -> Tuple[float, float]:
    """(W_s, W_b) with W_b = 1 - W_s."""
    if not 0.0 <= w_speed <= 1.0:
        raise ValueError(f"static speed weight must lie in [0, 1], got {w_speed}")
    return w_speed, 1.0 - w_speed


def combine(preds: Sequence[np.ndarray], weights: Sequence[float]) -> np.ndarray:
    out = np.zeros_like(np.asarray(preds[0], np.float64))
    for p, w in zip(preds, weights):
        out = out + w * np.asarray(p, np.float64)
    return out


def dwa_scipy(preds: Sequence[np.ndarray], y: np.ndarray) -> np.ndarray:
    """Dynamic Weighting Algorithm, faithful to Algorithm 1.

    preds: K arrays of predictions on the previous window's test set
    (speed model M^s_{t-1} first, batch model M^b second, by convention).
    Returns the K weights.
    """
    preds = [np.asarray(p, np.float64).ravel() for p in preds]
    y = np.asarray(y, np.float64).ravel()
    K = len(preds)
    P = np.stack(preds, axis=1)  # (n, K)

    def loss(w):
        return np.sqrt(np.mean((y - P @ w) ** 2))

    w0 = np.full(K, 0.5)  # paper: initial guess 0.5
    cons = {"type": "eq", "fun": lambda w: 1.0 - np.sum(w)}
    bounds = [(0.0, 1.0)] * K
    res = minimize(loss, w0, method="SLSQP", bounds=bounds, constraints=[cons])
    w = np.clip(res.x, 0.0, 1.0)
    s = w.sum()
    return w / s if s > 0 else np.full(K, 1.0 / K)


def dwa_closed_form(pred_speed: np.ndarray, pred_batch: np.ndarray,
                    y: np.ndarray) -> Tuple[float, float]:
    """K=2 exact solution.  min_w ||y - (w*ps + (1-w)*pb)||^2 over w in [0,1]
    (RMSE and MSE share the argmin):  w* = <y - pb, ps - pb> / ||ps - pb||^2.
    """
    ps = np.asarray(pred_speed, np.float64).ravel()
    pb = np.asarray(pred_batch, np.float64).ravel()
    y = np.asarray(y, np.float64).ravel()
    d = ps - pb
    denom = float(d @ d)
    if denom < 1e-18:
        return 0.5, 0.5
    w = float((y - pb) @ d / denom)
    w = min(max(w, 0.0), 1.0)
    return w, 1.0 - w
