"""The hybrid learner decomposed into discrete, individually-invokable
pipeline stages (paper Sec. 4.4), for one stream:

  batch_inference   (batch_params, x)            -> pred
  speed_inference   (speed_params, x)            -> pred [+ fallback flag]
  weight_solve      (prev_preds, prev_y)         -> w_speed, w_batch
  hybrid_combine    (pred_speed, pred_batch, w*) -> pred
  speed_training    (data, speed_params, batch_params, key)
                                                 -> params, eval_preds, eval_y
  model_sync        (params, eval_preds, eval_y) -> speed model state update
  data_sync         (records_nbytes,)            -> archive handoff

Each stage's ``compute(**inputs) -> dict`` is wrapped by ``__call__`` with a
wall-clock measurement.  The fleet stages come with the fleet slice, and
the signature check of ``model_sync`` with the health slice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.weighting import (
    combine,
    dwa_closed_form,
    dwa_scipy,
    static_weights,
)
from repro_torch.serving.quantize import (
    dequantize_tree,
    tree_checksum,
    tree_leaves,
)

Params = Any


def _tensor_leaves(tree: Any) -> Iterator[torch.Tensor]:
    """The tensors of a stage's outputs, a ``QTensor``'s ``q`` and
    ``scale`` among them."""
    return (x for x in tree_leaves(tree) if isinstance(x, torch.Tensor))


@dataclass
class StageOutput:
    """What one stage invocation produced, plus its measured wall-clock."""

    values: Dict[str, Any]
    wall_s: float

    def __getitem__(self, key: str) -> Any:
        return self.values[key]


class Stage:
    """Base: times ``compute`` with a perf counter.  CUDA work is
    asynchronous, so the wrapper synchronizes every device that holds an
    output tensor before stopping the clock; otherwise a stage would be
    credited with less than the work it started."""

    name: str = "stage"

    def compute(self, **inputs: Any) -> Dict[str, Any]:
        raise NotImplementedError

    def __call__(self, **inputs: Any) -> StageOutput:
        t0 = time.perf_counter()
        values = self.compute(**inputs)
        for dev in {t.device for t in _tensor_leaves(values) if t.is_cuda}:
            torch.cuda.synchronize(dev)
        return StageOutput(values=values, wall_s=time.perf_counter() - t0)


class BatchInference(Stage):
    """M^b prediction on a window's supervised inputs."""

    name = "batch_inference"

    def __init__(self, forecaster):
        self.forecaster = forecaster

    def compute(self, *, batch_params: Params, x: np.ndarray) -> Dict[str, Any]:
        return {"pred": self.forecaster.predict(batch_params, x)}


class SpeedInference(Stage):
    """M^s_{t-1} prediction.  When no speed model has been synced yet, the
    stage degrades to serving the batch model and flags it."""

    name = "speed_inference"

    def __init__(self, forecaster):
        self.forecaster = forecaster

    def compute(self, *, speed_params: Optional[Params], x: np.ndarray,
                fallback_params: Optional[Params] = None) -> Dict[str, Any]:
        fallback = speed_params is None
        params = fallback_params if fallback else speed_params
        if params is None:
            raise ValueError("speed_inference: no speed model and no fallback")
        return {"pred": self.forecaster.predict(params, x),
                "fallback": fallback}


class WeightSolve(Stage):
    """Algorithm 1 (dynamic) or static/degenerate weights.

    mode: "dynamic", ("static", w_speed), "speed", "batch".
    """

    name = "weight_solve"

    def __init__(self, mode="dynamic", dwa_solver: str = "closed_form"):
        self.mode = mode
        self.dwa_solver = dwa_solver

    def compute(self, *, prev_preds: Optional[Tuple[np.ndarray, np.ndarray]],
                prev_y: Optional[np.ndarray]) -> Dict[str, Any]:
        if isinstance(self.mode, tuple) and self.mode[0] == "static":
            ws, wb = static_weights(self.mode[1])
            return {"w_speed": ws, "w_batch": wb}
        if self.mode == "dynamic":
            if prev_preds is None:
                return {"w_speed": 0.5, "w_batch": 0.5}
            if self.dwa_solver == "scipy":
                w = dwa_scipy([prev_preds[0], prev_preds[1]], prev_y)
                ws, wb = float(w[0]), float(w[1])
            else:
                ws, wb = dwa_closed_form(prev_preds[0], prev_preds[1], prev_y)
            return {"w_speed": ws, "w_batch": wb}
        if self.mode == "speed":
            return {"w_speed": 1.0, "w_batch": 0.0}
        if self.mode == "batch":
            return {"w_speed": 0.0, "w_batch": 1.0}
        raise ValueError(f"unknown mode {self.mode!r}")

    @property
    def is_dynamic(self) -> bool:
        return self.mode == "dynamic"


class HybridCombine(Stage):
    """Pred_hybrid = W_s * Pred_speed + W_b * Pred_batch."""

    name = "hybrid_combine"

    def compute(self, *, pred_speed: np.ndarray, pred_batch: np.ndarray,
                w_speed: float, w_batch: float) -> Dict[str, Any]:
        return {"pred": combine([pred_speed, pred_batch], [w_speed, w_batch])}


class SpeedTraining(Stage):
    """Train M^s_t on window t's records and stash the Algorithm-1 inputs:
    predictions of (M^s_t, M^b) on window t, consumed when weighting window
    t+1.  ``train_wall_s`` is the forecaster-reported fit time (excludes the
    eval predictions); ``CompiledForecaster`` stops that clock after
    ``torch.cuda.synchronize()``, so it holds the fit's device work."""

    name = "speed_training"

    def __init__(self, forecaster):
        self.forecaster = forecaster

    def compute(self, *, data: Dict[str, np.ndarray],
                speed_params: Optional[Params], batch_params: Params,
                key) -> Dict[str, Any]:
        fc = self.forecaster
        if speed_params is not None:
            # the serving model may be the int8-synced tree (QTensor leaves);
            # training runs in float, so dequantize at the stage boundary
            # (no-op on a float tree)
            speed_params = dequantize_tree(speed_params)
        params, train_wall_s = fc.train(data, speed_params, key)
        x, y = data["x"], data["y"]
        eval_preds = eval_y = None
        if len(x) > 0:
            eval_preds = (fc.predict(params, x),
                          fc.predict(batch_params, x))
            eval_y = y
        return {"params": params, "train_wall_s": train_wall_s,
                "eval_preds": eval_preds, "eval_y": eval_y}


class ModelSync(Stage):
    """Install a freshly-published speed model (plus its Algorithm-1 eval
    predictions) as the serving state.  Pure pass-through compute; the cost
    of this module is the model transfer, which the executor accounts as
    communication.

    When the publish carries a ``checksum`` (``serving.quantize.
    tree_checksum``, stamped by the training site), the stage verifies it
    before installing anything: a mismatch returns ``ok=False`` with no
    state, and counts in ``corrupt_rejected``; a match counts in
    ``verified``.  A corrupt model is never served.  The HMAC signature
    check comes with the health slice: until then, passing ``signature`` or
    ``sig_key`` raises."""

    name = "model_sync"

    _REJECT = {"ok": False, "speed_params": None,
               "prev_preds": None, "prev_y": None}

    def __init__(self):
        self.verified = 0
        self.corrupt_rejected = 0

    def compute(self, *, params: Params, eval_preds, eval_y,
                checksum: Optional[int] = None,
                signature: Optional[str] = None,
                sig_key: Optional[bytes] = None) -> Dict[str, Any]:
        if signature is not None or sig_key is not None:
            raise NotImplementedError(
                "model_sync: signature verification comes with the health "
                "slice of the port")
        if checksum is not None:
            if tree_checksum(params) != checksum:
                self.corrupt_rejected += 1
                return dict(self._REJECT)
            self.verified += 1
        return {"ok": True, "speed_params": params, "prev_preds": eval_preds,
                "prev_y": eval_y}


class DataSync(Stage):
    """Raw-data archiving handoff (S3 analog); compute-free, its cost is the
    window transfer to the archiving site."""

    name = "data_sync"

    def compute(self, *, nbytes: float = 0.0) -> Dict[str, Any]:
        return {"nbytes": nbytes}


@dataclass
class PipelineStages:
    """The full stage set one executor drives.  Build with :meth:`build` so
    every executor runs literally the same stage objects."""

    batch_inference: BatchInference
    speed_inference: SpeedInference
    weight_solve: WeightSolve
    hybrid_combine: HybridCombine
    speed_training: SpeedTraining
    model_sync: ModelSync
    data_sync: DataSync

    @classmethod
    def build(cls, forecaster, mode="dynamic",
              dwa_solver: str = "closed_form") -> "PipelineStages":
        return cls(
            batch_inference=BatchInference(forecaster),
            speed_inference=SpeedInference(forecaster),
            weight_solve=WeightSolve(mode, dwa_solver),
            hybrid_combine=HybridCombine(),
            speed_training=SpeedTraining(forecaster),
            model_sync=ModelSync(),
            data_sync=DataSync(),
        )

    @property
    def mode(self):
        return self.weight_solve.mode
