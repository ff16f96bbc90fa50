"""Public entry point of the fused LSTM: ``lstm_sequence``.

The model layer rides it (``repro_torch.models.lstm.forward``).  Without a
gradient to take, a tensor on a CUDA device launches the serving kernel
(``kernel.lstm_sequence_fused``) and a tensor on the CPU takes its plain
version (``ref``).  When grad is enabled and an input requires it, the call
goes through ``_LSTMSequence``, the counterpart of the reference's
``jax.custom_vjp``: its forward is the residual-emitting kernel
(``kernel.lstm_sequence_fwd_train``) and its backward the reverse-time pair
(``kernel.lstm_sequence_bwd``), or their plain versions on the CPU.  A CUDA
tensor launches the kernels or raises; nothing falls back.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.lstm_cell import kernel, ref


class _LSTMSequence(torch.autograd.Function):
    """x, wx, wh, b -> final hidden (B,H) in ``x.dtype``, differentiable in
    all four.  Saves the residuals (post-activation gates, c_seq, h_seq, all
    float32) so the backward re-runs no product of the forward."""

    @staticmethod
    def forward(ctx, x, wx, wh, b):
        if x.device.type == "cuda":
            gates, c_seq, h_seq = kernel.lstm_sequence_fwd_train(x, wx, wh, b)
        else:
            gates, c_seq, h_seq = ref.lstm_sequence_fwd_train_ref(x, wx, wh, b)
        ctx.save_for_backward(x, gates, c_seq, h_seq, wx, wh)
        return h_seq[:, -1].to(dtype=x.dtype, copy=True)

    @staticmethod
    def backward(ctx, dh):
        x, gates, c_seq, h_seq, wx, wh = ctx.saved_tensors
        dh = dh.float().contiguous()
        dc = torch.zeros_like(dh)  # only the final h is an output
        bwd = (kernel.lstm_sequence_bwd if x.device.type == "cuda"
               else ref.lstm_sequence_bwd_ref)
        dx, dwx, dwh, db = bwd(x, gates, c_seq, h_seq, wx, wh, dh, dc)
        grads = (dx.to(x.dtype), dwx, dwh, db)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def lstm_sequence(x: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Fused full-sequence LSTM: x (B,T,F) -> final hidden (B,H) in
    ``x.dtype``.  ``wx`` is (F,4H), ``wh`` (H,4H), ``b`` (4H) with gate order
    (i, f, g, o); compute is float32."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"lstm_sequence: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, wx, wh, b)):
        return _LSTMSequence.apply(x, wx, wh, b)
    if x.device.type == "cuda":
        h, _ = kernel.lstm_sequence_fused(x, wx, wh, b)
        return h
    return ref.lstm_sequence_ref(x, wx, wh, b)
