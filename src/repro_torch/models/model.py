"""Model dispatcher: ``get_model(cfg)`` returns a ``Model`` whose functions
the hybrid learner consumes.  The port knows the LSTM family only; the
model zoo comes with its own slice, and ``loss_fn`` with the training slice.

    init(generator, device) -> params
    predict(params, x)      -> (B, out_dim)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig

Params = Dict[str, Dict[str, torch.Tensor]]


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[[torch.Generator, Optional[torch.device]], Params]
    predict: Callable[[Params, torch.Tensor], torch.Tensor]


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family == "lstm":
        from repro_torch.models import lstm as m

        return Model(
            cfg=cfg,
            init=lambda generator, device=None: m.init_params(
                cfg, generator, device),
            predict=lambda p, x: m.predict(cfg, p, x),
        )
    raise ValueError(f"unknown family {cfg.family!r}; the port has 'lstm'")
