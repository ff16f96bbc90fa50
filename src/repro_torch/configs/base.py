"""Config dataclasses of the port: the paper's forecaster only.

``ModelConfig`` keeps the reference's names for the fields the LSTM family
reads; the transformer fields, the model-zoo sub-configs and the TPU
hardware model wait for the zoo slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class LSTMConfig:
    """The paper's forecaster: LSTM(hidden) -> Dense(dense, relu) -> Dense(1)."""

    hidden: int = 40
    dense: int = 10
    n_features: int = 5
    lag: int = 5  # paper sets time lag n = 5
    out_dim: int = 1


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    param_dtype: str = "bfloat16"
    lstm: Optional[LSTMConfig] = None
    citation: str = ""
