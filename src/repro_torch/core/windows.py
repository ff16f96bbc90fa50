"""Time-window bookkeeping and supervised dataset construction.

The paper's problem statement (Sec. 5.1): with time lag n=5, predict
y^i from (y^{i-1}, ..., y^{i-n}); the stream is chopped into time windows of
>= 200 records (~30 s), the speed layer trains on window t and predicts
window t+1.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Tuple

import numpy as np


def make_supervised(series: np.ndarray, lag: int, target_col: int = 0
                    ) -> Dict[str, np.ndarray]:
    """(T, F) series -> {"x": (n, lag, F), "y": (n, 1)} with n = T - lag."""
    series = np.asarray(series, np.float32)
    if series.ndim == 1:
        series = series[:, None]
    T, F = series.shape
    n = T - lag
    if n <= 0:
        return {"x": np.zeros((0, lag, F), np.float32),
                "y": np.zeros((0, 1), np.float32)}
    idx = np.arange(lag)[None, :] + np.arange(n)[:, None]  # (n, lag)
    x = series[idx]  # (n, lag, F)
    y = series[lag:, target_col : target_col + 1]
    return {"x": x.astype(np.float32), "y": y.astype(np.float32)}


@dataclass(frozen=True)
class WindowPlan:
    n_windows: int
    records_per_window: int
    lag: int
    target_col: int = 0


class WindowedStream:
    """Iterates (window_index, window_records, supervised_data).

    Each window's supervised pairs include ``lag`` records of left context
    from the previous window so no boundary samples are lost.
    """

    def __init__(self, series: np.ndarray, plan: WindowPlan):
        self.series = np.asarray(series, np.float32)
        self.plan = plan

    def __len__(self) -> int:
        return min(self.plan.n_windows,
                   len(self.series) // self.plan.records_per_window)

    def window_records(self, t: int) -> np.ndarray:
        w = self.plan.records_per_window
        return self.series[t * w : (t + 1) * w]

    def supervised(self, t: int) -> Dict[str, np.ndarray]:
        w, lag = self.plan.records_per_window, self.plan.lag
        start = max(t * w - lag, 0)
        chunk = self.series[start : (t + 1) * w]
        return make_supervised(chunk, lag, self.plan.target_col)

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray, Dict[str, np.ndarray]]]:
        for t in range(len(self)):
            yield t, self.window_records(t), self.supervised(t)
