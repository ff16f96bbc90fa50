"""Model dispatcher: ``get_model(cfg)`` returns a ``Model`` whose functions
the hybrid learner and the trainers consume.  The port knows the LSTM family
only; the model zoo comes with its own slice.

    init(generator, device) -> params
    loss_fn(params, batch)  -> (loss, metrics)
    predict(params, x)      -> (B, out_dim)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig

Params = Dict[str, Dict[str, torch.Tensor]]
Batch = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[[torch.Generator, Optional[torch.device]], Params]
    loss_fn: Callable[[Params, Batch],
                      Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    predict: Callable[[Params, torch.Tensor], torch.Tensor]


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family == "lstm":
        from repro_torch.models import lstm as m

        return Model(
            cfg=cfg,
            init=lambda generator, device=None: m.init_params(
                cfg, generator, device),
            loss_fn=lambda p, b: m.loss_fn(cfg, p, b),
            predict=lambda p, x: m.predict(cfg, p, x),
        )
    raise ValueError(f"unknown family {cfg.family!r}; the port has 'lstm'")
