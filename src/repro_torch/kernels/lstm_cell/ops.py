"""Public entry point of the fused LSTM: ``lstm_sequence``.

The model layer rides it (``repro_torch.models.lstm.forward``).  A tensor on
a CUDA device launches the hand-written kernel (``kernel.lstm_sequence_fused``)
or raises; a tensor on the CPU takes the plain version (``ref``).  Only the
forward is ported: the backward kernels come with the training slice, so a
call that would need a gradient raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.lstm_cell.kernel import lstm_sequence_fused
from repro_torch.kernels.lstm_cell.ref import lstm_sequence_ref


def lstm_sequence(x: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Fused full-sequence LSTM: x (B,T,F) -> final hidden (B,H) in
    ``x.dtype``.  ``wx`` is (F,4H), ``wh`` (H,4H), ``b`` (4H) with gate order
    (i, f, g, o); compute is float32."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, wx, wh, b)):
        raise NotImplementedError(
            "lstm_sequence has no backward yet: the LSTM training kernels "
            "come with the training slice; call it under torch.no_grad() or "
            "torch.inference_mode()")
    if x.device.type == "cuda":
        h, _ = lstm_sequence_fused(x, wx, wh, b)
        return h
    if x.device.type == "cpu":
        return lstm_sequence_ref(x, wx, wh, b)
    raise ValueError(f"lstm_sequence: unsupported device {x.device}")
