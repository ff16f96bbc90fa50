"""Config registry: ``get_config(name)``.  The port knows the paper's
forecaster, ``tinyllama-1.1b``, ``rwkv6-3b`` and ``zamba2-1.2b``; each
other arch of the reference's zoo comes with the slice named in
``UNPORTED``."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import (HybridConfig, LSTMConfig, ModelConfig,
                                      RWKVConfig, SSMConfig)
from repro_torch.configs.lstm_paper import CONFIG as _lstm_paper
from repro_torch.configs.rwkv6_3b import CONFIG as _rwkv6
from repro_torch.configs.tinyllama_1_1b import CONFIG as _tinyllama
from repro_torch.configs.zamba2_1_2b import CONFIG as _zamba2

REGISTRY: Dict[str, ModelConfig] = {
    c.name: c for c in (_lstm_paper, _tinyllama, _rwkv6, _zamba2)}

# the reference's other archs -> the part of the port that brings them
# (ROADMAP.md, Queue A)
_REST_OF_ZOO = "the rest of the model zoo"
UNPORTED: Dict[str, str] = {name: _REST_OF_ZOO for name in (
    "paligemma-3b", "h2o-danube-3-4b", "codeqwen1.5-7b", "nemotron-4-15b",
    "grok-1-314b", "kimi-k2-1t-a32b", "seamless-m4t-medium")}


def get_config(name: str) -> ModelConfig:
    if name in UNPORTED:
        raise KeyError(f"arch {name!r} is not ported yet: it comes with "
                       f"{UNPORTED[name]}; available: {sorted(REGISTRY)}")
    if name not in REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(REGISTRY)}"
        )
    return REGISTRY[name]


__all__ = ["REGISTRY", "UNPORTED", "get_config", "HybridConfig", "LSTMConfig",
           "ModelConfig", "RWKVConfig", "SSMConfig"]
