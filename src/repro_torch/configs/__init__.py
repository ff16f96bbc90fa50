"""Config registry: ``get_config(name)``.  The port knows the paper's
forecaster only; the model zoo's configs come with the zoo slice."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import LSTMConfig, ModelConfig
from repro_torch.configs.lstm_paper import CONFIG as _lstm_paper

REGISTRY: Dict[str, ModelConfig] = {_lstm_paper.name: _lstm_paper}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(REGISTRY)}"
        )
    return REGISTRY[name]


__all__ = ["REGISTRY", "get_config", "LSTMConfig", "ModelConfig"]
