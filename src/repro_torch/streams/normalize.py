"""Min-Max scaling to [0, 1] (paper Sec. 6.1.2) with inverse transform."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class MinMaxScaler:
    lo: np.ndarray
    hi: np.ndarray

    @classmethod
    def fit(cls, x: np.ndarray) -> "MinMaxScaler":
        return cls(lo=x.min(axis=0), hi=x.max(axis=0))

    def transform(self, x: np.ndarray) -> np.ndarray:
        span = np.maximum(self.hi - self.lo, 1e-12)
        return ((x - self.lo) / span).astype(np.float32)

    def inverse(self, x: np.ndarray, col: int | None = None) -> np.ndarray:
        if col is None:
            span = np.maximum(self.hi - self.lo, 1e-12)
            return x * span + self.lo
        span = max(self.hi[col] - self.lo[col], 1e-12)
        return x * span + self.lo[col]
