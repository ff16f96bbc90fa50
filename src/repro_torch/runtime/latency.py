"""Compute-cost calibration and per-window latency accounting.

``CostModel`` holds *measured* wall-times of the real modules on the
machine (LSTM batch/speed inference, speed training, weight solve) and
rescales them by each site's ``compute_scale``; big-arch costs can instead be
derived from the roofline terms of the compiled dry-run.  The accounting
separates computation vs communication per module, which is exactly the
structure of the paper's Table 3.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np


@dataclass
class CostModel:
    """Seconds, measured on the container at compute_scale=1.0."""

    batch_infer_s: float = 0.05
    speed_infer_s: float = 0.05
    hybrid_combine_s: float = 0.005
    weight_solve_s: float = 0.01  # dynamic only
    speed_train_s: float = 2.0
    ingest_s: float = 0.0  # Kafka data-injection throttle time charged as
    # communication on every stream consumer (paper: ~7 records/s)
    model_nbytes: float = 50_000.0  # checkpoint size (lstm-paper: 7,781 f32
    # params, 31,124 B)
    window_nbytes: float = 200 * 5 * 4  # records/window * features * f32
    result_nbytes: float = 200 * 4
    # memory footprint of a training job (for the capacity model)
    train_memory_bytes: float = 6e9  # TF/Spark stack on the Pi blows 4 GB
    infer_memory_bytes: float = 0.5e9
    # how long an over-capacity training attempt thrashes its site before
    # the OOM kill (swap-paging the overshoot on Pi-class storage).  Modeled,
    # not measured: this container cannot OOM a real Pi, and the *successful*
    # training wall is no proxy for it — the compiled hot path dropped that
    # wall to milliseconds while a thrashing attempt still takes seconds.
    oom_thrash_s: float = 4.0

    def on(self, site_scale: float, seconds: float) -> float:
        return seconds / max(site_scale, 1e-9)


@dataclass
class LatencyLedger:
    """Accumulates (computation, communication, queue) seconds per (module,
    window).  ``queue`` is the time a stage waited for a free worker on its
    site (only the measured ``BusExecutor`` path produces nonzero queueing;
    the calibrated simulation does not model site occupancy).

    ``depth`` is a per-*site* backlog time series — ``(t, backlog_s)``
    samples of how many seconds of already-admitted work sit in front of a
    fresh arrival.  Executors sample it both at stage entry *and* at publish
    (stage-exit) time: entry-only sampling aliased inter-window queue growth
    to zero, which starved the placement controller (and BENCH_serving) of
    the very signal scaling decisions are made from."""

    comp: Dict[str, list] = field(default_factory=dict)
    comm: Dict[str, list] = field(default_factory=dict)
    queue: Dict[str, list] = field(default_factory=dict)
    depth: Dict[str, list] = field(default_factory=dict)

    def add(self, module: str, comp_s: float = 0.0, comm_s: float = 0.0,
            queue_s: float = 0.0):
        self.comp.setdefault(module, []).append(comp_s)
        self.comm.setdefault(module, []).append(comm_s)
        self.queue.setdefault(module, []).append(queue_s)

    def sample_depth(self, site: str, t: float, backlog_s: float) -> None:
        """Record one (virtual-time, backlog-seconds) queue-depth sample for
        ``site``."""
        self.depth.setdefault(site, []).append((float(t), float(backlog_s)))

    def depth_series(self, site: str) -> list:
        return self.depth.get(site, [])

    def depth_ewma(self, site: str, alpha: float = 0.3) -> float:
        """EWMA of the site's backlog samples (most recent weighted by
        ``alpha``); 0.0 when no samples exist."""
        ewma = 0.0
        for _, b in self.depth.get(site, []):
            ewma = (1.0 - alpha) * ewma + alpha * b
        return ewma

    def table(self) -> Dict[str, Dict[str, float]]:
        out = {}
        mods = set(self.comp) | set(self.comm)
        for m in sorted(mods):
            c = float(np.mean(self.comp.get(m, [0.0])))
            x = float(np.mean(self.comm.get(m, [0.0])))
            q = float(np.mean(self.queue.get(m, [0.0])))
            out[m] = {"computation": c, "communication": x, "queue": q,
                      "total": c + x + q}
        return out
