"""The paper's forecaster (Sec. 6.1.2 / Fig. 6): LSTM(40) -> Dense(10, ReLU)
-> Dense(1), lag n=5, 5 input features.

Params are a nested dict of tensors with the reference's keys:
``lstm/kernel`` (F,4H), ``lstm/recurrent`` (H,4H), ``lstm/bias`` (4H),
``dense/dense_w``, ``dense/dense_b``, ``head/head_w``, ``head/head_b``.
The float recurrence always goes through
``kernels.lstm_cell.ops.lstm_sequence``: the CUDA kernels on the card (the
serving forward, or under a gradient the training pair), their plain
versions on the CPU.  A tree with ``QTensor`` leaves (an int8-synced speed
model) serves through ``_forward_int8``, whose every quantized product is
``kernels.int8_matmul.ops.qmatmul``.  ``loss_fn`` is the masked MSE the
trainers differentiate.

A fleet's params are one stacked tree, every leaf with a leading stream axis
S (a stacked ``QTensor``: q (S,K,N), scale (S,N)), and its inputs carry the
same axis: ``forward`` maps x (S,B,lag,F) to (S,B,out), the recurrence one
launch of the stream-axis kernels for the whole fleet, Dense(10) and the
head batched products; ``loss_fn`` returns each stream's loss, shape (S,).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.int8_matmul.ops import qmatmul
from repro_torch.kernels.lstm_cell import ops as lstm_ops
from repro_torch.models import nn
from repro_torch.serving.quantize import QTensor

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


def stacked(p: Params) -> bool:
    """Whether ``p`` is a fleet's stacked tree (leaves with a leading
    stream axis) rather than one stream's."""
    k = p["lstm"]["kernel"]
    return (k.q if isinstance(k, QTensor) else k).dim() == 3


def _row(b: torch.Tensor) -> torch.Tensor:
    """A bias added to (B, N) rows: a fleet's (S, N) gains the row axis."""
    return b if b.dim() == 1 else b.unsqueeze(-2)


def _mm(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w, through the int8 dequantizing matmul when ``w`` is a
    ``QTensor`` (float leaves multiply as usual, so a partly quantized tree,
    its tiny head kept in float, still serves)."""
    if isinstance(w, QTensor):
        return qmatmul(x, w)
    return x @ w


def _forward_int8(cfg: ModelConfig, p: Params, x: torch.Tensor
                  ) -> torch.Tensor:
    """Edge inference on an int8-synced speed model, as the reference's
    ``_forward_int8``: the whole-sequence input projection in one
    ``qmatmul`` of (B*T, F), the recurrent projection one ``qmatmul`` of
    (B, H) a step (t = 0 included), the gate math in plain torch, and
    Dense(10) one ``qmatmul``; activations stay float (weight-only
    quantization).  A stacked tree takes x (S,B,T,F): every ``qmatmul`` is
    then one launch for the fleet."""
    H = cfg.lstm.hidden
    T = x.shape[-2]
    lead = x.shape[:-2]  # (B,) or (S, B)
    lp = p["lstm"]
    zx = _mm(x.reshape(*x.shape[:-3], -1, x.shape[-1]),
             lp["kernel"]).reshape(*lead, T, 4 * H)
    h = torch.zeros((*lead, H), dtype=x.dtype, device=x.device)
    c = torch.zeros((*lead, H), dtype=x.dtype, device=x.device)
    for t in range(T):
        z = zx[..., t, :] + _mm(h, lp["recurrent"]) + _row(lp["bias"])
        i, f, g, o = z.split(H, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c = f * c + i * torch.tanh(g)
        h = o * torch.tanh(c)
    d = torch.relu(_mm(h, p["dense"]["dense_w"])
                   + _row(p["dense"]["dense_b"]))
    return _mm(d, p["head"]["head_w"]) + _row(p["head"]["head_b"])


def forward(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, lag, F) -> prediction (B, out_dim); a stacked tree takes x
    (S, B, lag, F) -> (S, B, out_dim).  A tree with ``QTensor`` leaves
    serves through ``_forward_int8``."""
    if any(isinstance(v, QTensor) for sub in p.values() for v in sub.values()):
        return _forward_int8(cfg, p, x)
    lp = p["lstm"]
    h = lstm_ops.lstm_sequence(x, lp["kernel"], lp["recurrent"], lp["bias"])
    if not stacked(p):
        d = torch.relu(h @ p["dense"]["dense_w"] + p["dense"]["dense_b"])
        return d @ p["head"]["head_w"] + p["head"]["head_b"]
    d = torch.relu(torch.bmm(h, p["dense"]["dense_w"])
                   + _row(p["dense"]["dense_b"]))
    return torch.bmm(d, p["head"]["head_w"]) + _row(p["head"]["head_b"])


def loss_fn(cfg: ModelConfig, p: Params, batch: Dict[str, torch.Tensor]):
    """MSE regression loss.  batch: {"x": (B,lag,F), "y": (B,out)} plus an
    optional per-example validity "mask" (B,): 1 for real examples, 0 for
    the padding the fixed-shape-bucket trainer adds.  A masked batch yields
    exactly the unpadded mean, so every shape bucket trains the same loss.
    Returns ``(loss, {"mse", "rmse"})``, all float32 scalars.  A stacked
    tree takes a stacked batch (x (S,B,lag,F), y (S,B,out), mask (S,B)) and
    returns each stream's loss and metrics, shape (S,): a stream whose mask
    is all zero (a padded slot) has loss 0 and gradient 0."""
    pred = forward(cfg, p, batch["x"])
    err = (pred - batch["y"]).float()
    sq = err * err
    mask = batch.get("mask")
    if stacked(p):
        dims = (1, 2)
        if mask is None:
            loss = sq.mean(dim=dims)
        else:
            m = mask.float()[..., None]
            denom = torch.clamp(m.sum(dim=dims), min=1.0) * sq.shape[-1]
            loss = (sq * m).sum(dim=dims) / denom
    elif mask is None:
        loss = sq.mean()
    else:
        m = mask.float()[:, None]
        denom = torch.clamp(m.sum(), min=1.0) * sq.shape[-1]
        loss = (sq * m).sum() / denom
    return loss, {"mse": loss, "rmse": torch.sqrt(loss)}


def predict(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return forward(cfg, p, x)
