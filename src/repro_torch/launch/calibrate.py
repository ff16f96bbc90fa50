"""Measure the real wall-times of the paper's modules on the card (LSTM
batch/speed inference, speed training, DWA solve) to calibrate the
edge-cloud runtime's ``CostModel``: the launcher's default mode replays
these constants in ``runtime.modules.EdgeCloudSimulation``.

The port's own copy of the reference's ``benchmarks/calibrate.py``, the same
window, forecaster, repeats and constants.  The paper's absolute Table-3
numbers come from a Pi 4 + TFLite + Kafka + AWS stack; this reports the
measured computation plus the modeled communication, and the paper's
*orderings and ratios* are what it validates, not its absolute seconds.

``model_nbytes`` stays the reference's 44,000 B, though the float sync of
``lstm-paper`` is 31,124 B (7,781 float32 params): the simulation's tables
are held to the reference's.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Union

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import lstm_forecaster, make_supervised
from repro_torch.core.weighting import dwa_scipy
from repro_torch.runtime.latency import CostModel
from repro_torch.streams.sources import wind_turbine_series


@dataclass
class Calibration:
    cost: CostModel
    details: dict


def calibrate(records_per_window: int = 250, speed_epochs: int = 100,
              fast: bool = False,
              device: Optional[Union[str, torch.device]] = None
              ) -> Calibration:
    """The ``CostModel`` of one ``records_per_window`` window of the turbine
    series, measured on ``device`` (the current CUDA device by default):
    the compiled speed fit (``speed_epochs`` x batch 64, 10 epochs with
    ``fast``) timed on its second run, the mean of 5 predicts after one
    warm-up, the mean of 5 SLSQP weight solves."""
    dev = resolve_device(device)
    cfg = get_config("lstm-paper")
    if fast:
        speed_epochs = 10
    series = wind_turbine_series(records_per_window * 4, seed=0)
    data = make_supervised(series[: records_per_window + 5], 5, 0)

    fc = lstm_forecaster(cfg, epochs=speed_epochs, batch_size=64, device=dev)
    params, t_train = fc.train(data, None, 0)
    # re-measure training warm (the paper's steady-state windows)
    _, t_train = fc.train(data, None, 0)

    x = data["x"]
    fc.predict(params, x)  # warmup
    t0 = time.perf_counter()
    for _ in range(5):
        preds = fc.predict(params, x)
    t_infer = (time.perf_counter() - t0) / 5

    y = data["y"]
    t0 = time.perf_counter()
    for _ in range(5):
        dwa_scipy([preds, preds * 0.9], y)
    t_dwa = (time.perf_counter() - t0) / 5

    # paper's Kafka injection: ~7 records/s for >=200-record windows; the
    # effective pipelined ingest overhead charged to communication
    ingest_s = records_per_window / 7.0 * 0.45

    cost = CostModel(
        batch_infer_s=t_infer,
        speed_infer_s=t_infer * 1.05,  # includes model (re)load from disk
        hybrid_combine_s=t_infer * 0.1,
        weight_solve_s=t_dwa,
        speed_train_s=t_train,
        ingest_s=ingest_s,
        model_nbytes=44_000.0,
        window_nbytes=records_per_window * 5 * 4,
        result_nbytes=records_per_window * 4,
    )
    return Calibration(cost=cost, details={
        "t_train_s": t_train, "t_infer_s": t_infer, "t_dwa_s": t_dwa,
        "speed_epochs": speed_epochs,
    })
