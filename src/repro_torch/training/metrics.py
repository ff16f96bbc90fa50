"""Structured metric logging: JSONL writer + in-memory aggregator used by
the training loop, the serving engine and the edge-cloud runtime.

A copy of the reference's ``training/metrics.py``, which needs numpy only:
the JSONL rows are the same, so either package reads the other's files.
A tensor metric is read as a Python float (one device read a value).
"""
from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


def _scalarize(v: Any) -> Any:
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


@dataclass
class MetricLogger:
    """Append-only JSONL metric stream with windowed means."""

    path: Optional[str] = None
    _rows: List[Dict[str, Any]] = field(default_factory=list)
    _fh: Any = None

    def __post_init__(self):
        if self.path:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._fh = open(self.path, "a")

    def log(self, step: int, **metrics: Any) -> None:
        row = {"step": int(step), "time": time.time()}
        row.update({k: _scalarize(v) for k, v in metrics.items()})
        self._rows.append(row)
        if self._fh:
            self._fh.write(json.dumps(row) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    # -- aggregation ---------------------------------------------------------

    def mean(self, key: str, last_n: Optional[int] = None) -> float:
        vals = [r[key] for r in self._rows if key in r
                and isinstance(r[key], float)]
        if last_n:
            vals = vals[-last_n:]
        return float(np.mean(vals)) if vals else float("nan")

    def series(self, key: str) -> List[float]:
        return [r[key] for r in self._rows if key in r
                and isinstance(r[key], float)]

    def summary(self) -> Dict[str, Dict[str, float]]:
        cols = defaultdict(list)
        for r in self._rows:
            for k, v in r.items():
                if k in ("step", "time") or not isinstance(v, float):
                    continue
                cols[k].append(v)
        return {
            k: {"mean": float(np.mean(v)), "min": float(np.min(v)),
                "max": float(np.max(v)), "last": v[-1], "n": len(v)}
            for k, v in cols.items() if v
        }

    @classmethod
    def read(cls, path: str) -> "MetricLogger":
        ml = cls()
        with open(path) as f:
            for line in f:
                if line.strip():
                    ml._rows.append(json.loads(line))
        return ml
