"""Weight-combination algorithms for the hybrid layer (paper Sec. 5.3).

``Pred_hybrid = W_s * Pred_speed + W_b * Pred_batch``, ``W_s + W_b = 1``.

* ``static_weights`` — fixed (W_s, W_b), the paper evaluates 3:7, 5:5, 7:3.

* ``dwa_scipy`` — the paper's Algorithm 1 verbatim: stack the batch model and
  the previous-window speed model, collect their predictions on the previous
  window's test set, and minimize RMSE with scipy SLSQP, init 0.5 each,
  bounds [0,1], constraint sum(W)=1.

* ``dwa_closed_form`` — the exact K=2 solution (clipped least squares on the
  simplex).

* ``dwa_projected`` — the K-model counterpart of the reference's
  ``dwa_jax``: projected gradient descent of the combination's MSE on the
  probability simplex, in float32 as the reference's.

All of it runs on the host in numpy, as in the reference: the inputs are one
window's predictions.
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


def _project_simplex(v: np.ndarray) -> np.ndarray:
    """Euclidean projection onto the probability simplex (sorted
    algorithm), in v's dtype."""
    K = v.shape[0]
    u = np.sort(v)[::-1]
    css = np.cumsum(u)
    idx = np.arange(1, K + 1, dtype=v.dtype)
    rho = int(np.sum(u + (1.0 - css) / idx > 0))
    lam = (v.dtype.type(1.0) - css[rho - 1]) / v.dtype.type(rho)
    return np.maximum(v + lam, v.dtype.type(0.0))


def dwa_projected(preds: np.ndarray, y: np.ndarray, n_steps: int = 200,
                  lr: float = 0.5) -> np.ndarray:
    """K-model DWA: projected gradient descent on the simplex, float32.

    preds: (K, n); y: (n,).  Minimizes the MSE (the RMSE's argmin) of the
    convex combination from equal weights, ``n_steps`` steps of ``lr``
    over the predictions' mean square, each projected exactly onto the
    simplex.  Returns the (K,) weights."""
    f32 = np.float32
    preds = np.asarray(preds, f32)
    y = np.asarray(y, f32).ravel()
    K, n = preds.shape
    scale = max(f32(np.mean(preds * preds)), f32(1e-12))
    step = f32(lr) / scale
    w = np.full((K,), 1.0 / K, f32)
    for _ in range(n_steps):
        r = y - w @ preds
        grad = (f32(-2.0) / f32(n)) * (preds @ r)  # d mean(r^2) / dw
        w = _project_simplex((w - step * grad).astype(f32))
    return w
