"""The paper's forecaster (Sec. 6.1.2 / Fig. 6): LSTM(40) -> Dense(10, ReLU)
-> Dense(1), lag n=5, 5 input features.

Params are a nested dict of tensors with the reference's keys:
``lstm/kernel`` (F,4H), ``lstm/recurrent`` (H,4H), ``lstm/bias`` (4H),
``dense/dense_w``, ``dense/dense_b``, ``head/head_w``, ``head/head_b``.
The recurrence always goes through ``kernels.lstm_cell.ops.lstm_sequence``:
the CUDA kernels on the card (the serving forward, or under a gradient the
training pair), their plain versions on the CPU.  ``loss_fn`` is the masked
MSE the trainers differentiate.  The int8 (``QTensor``) serving path comes
with the int8-sync slice.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.lstm_cell import ops as lstm_ops
from repro_torch.models import nn

Params = Dict[str, Dict[str, torch.Tensor]]


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: Optional[torch.device] = None) -> Params:
    c = cfg.lstm
    dev = resolve_device(device)
    dt = getattr(torch, cfg.param_dtype)
    H, F = c.hidden, c.n_features
    return {
        "lstm": {
            "kernel": nn.dense_init(generator, F, 4 * H, dt, device=dev),
            "recurrent": nn.dense_init(generator, H, 4 * H, dt,
                                       scale=H**-0.5, device=dev),
            "bias": _forget_bias(H, dt, dev),
        },
        "dense": {
            "dense_w": nn.dense_init(generator, H, c.dense, dt, device=dev),
            "dense_b": torch.zeros((c.dense,), dtype=dt, device=dev),
        },
        "head": {
            "head_w": nn.dense_init(generator, c.dense, c.out_dim, dt,
                                    device=dev),
            "head_b": torch.zeros((c.out_dim,), dtype=dt, device=dev),
        },
    }


def _forget_bias(H: int, dt: torch.dtype, device: torch.device) -> torch.Tensor:
    """Keras-style unit forget-gate bias (gate order i, f, g, o)."""
    b = torch.zeros((4 * H,), dtype=torch.float32, device=device)
    b[H : 2 * H] = 1.0
    return b.to(dt)


def forward(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, lag, F) -> prediction (B, out_dim)."""
    leaves = [v for sub in p.values() for v in sub.values()]
    if not all(isinstance(v, torch.Tensor) for v in leaves):
        raise TypeError(
            "repro_torch.models.lstm.forward takes a params tree of tensors; "
            "quantized (QTensor) leaves come with the int8-sync slice")
    lp = p["lstm"]
    h = lstm_ops.lstm_sequence(x, lp["kernel"], lp["recurrent"], lp["bias"])
    d = torch.relu(h @ p["dense"]["dense_w"] + p["dense"]["dense_b"])
    return d @ p["head"]["head_w"] + p["head"]["head_b"]


def loss_fn(cfg: ModelConfig, p: Params, batch: Dict[str, torch.Tensor]):
    """MSE regression loss.  batch: {"x": (B,lag,F), "y": (B,out)} plus an
    optional per-example validity "mask" (B,): 1 for real examples, 0 for
    the padding the fixed-shape-bucket trainer adds.  A masked batch yields
    exactly the unpadded mean, so every shape bucket trains the same loss.
    Returns ``(loss, {"mse", "rmse"})``, all float32 scalars."""
    pred = forward(cfg, p, batch["x"])
    err = (pred - batch["y"]).float()
    sq = err * err
    mask = batch.get("mask")
    if mask is None:
        loss = sq.mean()
    else:
        m = mask.float()[:, None]
        denom = torch.clamp(m.sum(), min=1.0) * sq.shape[-1]
        loss = (sq * m).sum() / denom
    return loss, {"mse": loss, "rmse": torch.sqrt(loss)}


def predict(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return forward(cfg, p, x)
