"""Config registry: ``get_config(name)``.  The port serves all ten
assigned archs of the reference's zoo: the dense transformers
(``tinyllama-1.1b``, ``h2o-danube-3-4b``, ``codeqwen1.5-7b``,
``nemotron-4-15b``), the mixture-of-experts ones (``grok-1-314b``,
``kimi-k2-1t-a32b``), ``rwkv6-3b``, ``zamba2-1.2b``, the VLM
``paligemma-3b`` and the encoder-decoder ``seamless-m4t-medium``, beside
the paper's forecaster."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import (H100, SHAPES, EncDecConfig,
                                      FrontendStub, HardwareModel,
                                      HybridConfig, InputShape, LSTMConfig,
                                      ModelConfig, MoEConfig, RWKVConfig,
                                      SSMConfig, shape_applicable)
from repro_torch.configs.codeqwen1_5_7b import CONFIG as _codeqwen
from repro_torch.configs.grok_1_314b import CONFIG as _grok
from repro_torch.configs.h2o_danube_3_4b import CONFIG as _danube
from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as _kimi
from repro_torch.configs.lstm_paper import CONFIG as _lstm_paper
from repro_torch.configs.nemotron_4_15b import CONFIG as _nemotron
from repro_torch.configs.paligemma_3b import CONFIG as _paligemma
from repro_torch.configs.rwkv6_3b import CONFIG as _rwkv6
from repro_torch.configs.seamless_m4t_medium import CONFIG as _seamless
from repro_torch.configs.tinyllama_1_1b import CONFIG as _tinyllama
from repro_torch.configs.zamba2_1_2b import CONFIG as _zamba2

# the ten assigned architectures, in the reference's assignment order
ASSIGNED: List[ModelConfig] = [_paligemma, _danube, _codeqwen, _nemotron,
                               _grok, _kimi, _tinyllama, _rwkv6, _zamba2,
                               _seamless]

REGISTRY: Dict[str, ModelConfig] = {c.name: c for c in ASSIGNED}
REGISTRY[_lstm_paper.name] = _lstm_paper


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(REGISTRY)}"
        )
    return REGISTRY[name]


def get_shape(name: str) -> InputShape:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


__all__ = ["ASSIGNED", "REGISTRY", "SHAPES", "H100", "get_config",
           "get_shape", "shape_applicable", "EncDecConfig", "FrontendStub",
           "HardwareModel", "HybridConfig", "InputShape", "LSTMConfig",
           "ModelConfig", "MoEConfig", "RWKVConfig", "SSMConfig"]
