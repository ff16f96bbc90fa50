"""Adaptive hybrid stream analytics (paper Sec. 5): lambda-architecture
orchestration of batch, speed and hybrid layers over a windowed stream.

Per time window t (paper Fig. 4):

  inference phase: batch inference with the one-time pre-trained model M^b;
  speed inference with M^s_{t-1} (trained on the previous window); hybrid
  inference combines the two with static or dynamic (Algorithm 1) weights.

  training phase: speed training of M^s_t on window t's records.

``lstm_forecaster`` builds the paper's setup on the card: it predicts
through the LSTM serving kernel and trains through the LSTM training
kernels (``repro_torch.training.compiled.CompiledForecaster``; with
``compiled=False`` the legacy per-minibatch ``training.train_loop.fit``).  A caller
may replace ``train`` (``dataclasses.replace(forecaster, train=...)``): with
a trainer that installs speed models published elsewhere, the edge's view of
the paper's edge-cloud deployment, or with one that hands the engine draws
made elsewhere.  ``lstm_fleet_forecaster`` lifts it to a fleet of streams
(``FleetForecaster``: one stacked fit and one stacked predict per window for
the whole fleet).

The per-window work lives in ``repro_torch.core.stages`` as pipeline
stages; ``HybridStreamAnalytics.run`` drives them through
``repro_torch.runtime.executor.InProcessExecutor``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.windows import WindowedStream
from repro_torch.models import lstm as lstm_mod
from repro_torch.models.model import get_model
from repro_torch.training.compiled import CompiledForecaster, FleetForecaster
from repro_torch.training.train_loop import fit

Params = Any


@dataclass(frozen=True)
class Forecaster:
    """train(data, params, key) -> (params, wall_s); predict(params, x) -> y.

    ``key`` is an integer seed for the window's training.  ``engine``
    exposes the backing trainer, for ``lstm_forecaster`` the
    ``CompiledForecaster`` with its counters and ``fit_window``."""

    train: Callable[[Dict[str, np.ndarray], Optional[Params], int],
                    Tuple[Params, float]]
    predict: Callable[[Params, np.ndarray], np.ndarray]
    engine: Any = None


def lstm_forecaster(cfg: ModelConfig, *, epochs: int, batch_size: int,
                    lr: float = 1e-3, warm_start: bool = False,
                    compiled: bool = True,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Forecaster:
    """The paper's LSTM forecaster on ``device`` (the current CUDA device by
    default).  ``predict`` takes params on that device and host inputs, and
    returns host predictions.  ``compiled=True`` (default): ``train`` runs
    ``CompiledForecaster``: windows padded to a fixed shape bucket, the
    epoch permutations drawn up front, no host sync inside the step loop.
    ``compiled=False`` keeps the legacy per-call ``fit`` (one step a
    minibatch, the ragged last batch unpadded; no ``engine``), the baseline
    the compiled path is measured against."""
    dev = resolve_device(device)
    model = get_model(cfg)
    predict = _host_predict(cfg, dev)
    if compiled:
        eng = CompiledForecaster(model, epochs=epochs, batch_size=batch_size,
                                 lr=lr, warm_start=warm_start,
                                 predict_fn=predict, device=dev)
        return Forecaster(train=eng.train, predict=eng.predict, engine=eng)

    def train(data, params, key):
        res = fit(model, data, epochs=epochs, batch_size=batch_size, lr=lr,
                  params=params if warm_start else None, key=key, device=dev)
        return res.params, res.wall_time_s

    return Forecaster(train=train, predict=predict)


def _host_predict(cfg: ModelConfig, dev: torch.device
                  ) -> Callable[[Params, np.ndarray], np.ndarray]:
    """predict(params on ``dev``, host x) -> host predictions."""

    def predict(params: Params, x: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            xt = torch.as_tensor(np.asarray(x, np.float32), device=dev)
            return lstm_mod.predict(cfg, params, xt).cpu().numpy()

    return predict


def lstm_fleet_forecaster(cfg: ModelConfig, *, epochs: int, batch_size: int,
                          lr: float = 1e-3,
                          device: Optional[Union[str, torch.device]] = None
                          ) -> FleetForecaster:
    """The paper's LSTM speed layer lifted to a fleet of streams on
    ``device`` (the current CUDA device by default): a ``FleetForecaster``
    that trains every stream's speed model in one stacked fit per window,
    each step one launch of each LSTM training kernel for the whole fleet,
    and satisfies the single-stream ``Forecaster`` protocol by delegating
    to its wrapped ``CompiledForecaster``."""
    dev = resolve_device(device)
    return FleetForecaster(get_model(cfg), epochs=epochs,
                           batch_size=batch_size, lr=lr,
                           predict_fn=_host_predict(cfg, dev), device=dev)


@dataclass
class WindowRecord:
    window: int
    rmse_batch: float
    rmse_speed: float
    rmse_hybrid: float
    w_speed: float
    w_batch: float
    t_speed_train: float = 0.0
    t_batch_infer: float = 0.0
    t_speed_infer: float = 0.0
    t_hybrid_infer: float = 0.0
    t_weight_solve: float = 0.0


@dataclass
class HybridRunResult:
    records: List[WindowRecord]
    mode: str

    def mean_rmse(self) -> Dict[str, float]:
        return {
            "batch": float(np.mean([r.rmse_batch for r in self.records])),
            "speed": float(np.mean([r.rmse_speed for r in self.records])),
            "hybrid": float(np.mean([r.rmse_hybrid for r in self.records])),
        }

    def best_fraction(self) -> Dict[str, float]:
        """Paper Tables 4-6: time percentage each inference is the best."""
        wins = {"batch": 0, "speed": 0, "hybrid": 0}
        for r in self.records:
            best = min(
                ("speed", r.rmse_speed),
                ("batch", r.rmse_batch),
                ("hybrid", r.rmse_hybrid),
                key=lambda kv: kv[1],
            )[0]
            wins[best] += 1
        n = max(len(self.records), 1)
        return {k: v / n for k, v in wins.items()}

    def mean_latency(self) -> Dict[str, float]:
        return {
            "speed_train": float(np.mean([r.t_speed_train for r in self.records])),
            "batch_infer": float(np.mean([r.t_batch_infer for r in self.records])),
            "speed_infer": float(np.mean([r.t_speed_infer for r in self.records])),
            "hybrid_infer": float(np.mean([r.t_hybrid_infer for r in self.records])),
            "weight_solve": float(np.mean([r.t_weight_solve for r in self.records])),
        }


class HybridStreamAnalytics:
    """The adaptive hybrid learner.

    mode: "dynamic" (Algorithm 1), ("static", w_speed), "speed", "batch".
    ``dwa_solver``: "scipy" (paper SLSQP) or "closed_form".
    """

    def __init__(
        self,
        forecaster: Forecaster,
        mode: Union[str, Tuple[str, float]] = "dynamic",
        dwa_solver: str = "closed_form",
    ):
        self.forecaster = forecaster
        self.mode = mode
        self.dwa_solver = dwa_solver

    def stages(self):
        """The learner decomposed into pipeline stages."""
        from repro_torch.core.stages import PipelineStages

        return PipelineStages.build(self.forecaster, self.mode,
                                    self.dwa_solver)

    def run(
        self,
        stream: WindowedStream,
        batch_params: Params,
        seed: int,
        start_window: int = 1,
    ) -> HybridRunResult:
        from repro_torch.runtime.executor import InProcessExecutor

        return InProcessExecutor(self.stages(), start_window=start_window).run(
            stream, batch_params, seed)


def pretrain_batch_model(
    forecaster: Forecaster, historical: Dict[str, np.ndarray], key: int
) -> Tuple[Params, float]:
    """One-time batch training on historical data (paper: 20k observations,
    50 epochs, batch 512)."""
    return forecaster.train(historical, None, key)
