"""Public entry points of the LSTM kernels: the fused ``lstm_sequence``, and
the per-step ``lstm_step`` and ``lstm_sequence_scan``.

The model layer rides ``lstm_sequence`` (``repro_torch.models.lstm.forward``).
Without a gradient to take, a tensor on a CUDA device launches the serving
kernel (``kernel.lstm_sequence_fused``) and a tensor on the CPU takes its
plain version (``ref``).  When grad is enabled and an input requires it, the
call goes through ``_LSTMSequence``, the counterpart of the reference's
``jax.custom_vjp``: its forward is the residual-emitting kernel
(``kernel.lstm_sequence_fwd_train``) and its backward the reverse-time pair
(``kernel.lstm_sequence_bwd``), or their plain versions on the CPU.

``lstm_sequence`` takes a leading stream axis as its kernels do: x
(S,B,T,F) with stacked weights wx (S,F,4H), wh (S,H,4H), b (S,4H) is a
fleet of S LSTMs in one launch of each kernel, h (S,B,H) out, and under a
gradient every stream's own weight gradients.

``lstm_step`` is one step through the one-step kernel (``kernel.lstm_cell``),
and ``lstm_sequence_scan`` the pre-fusion baseline: one such launch a
timestep, the launch-overhead comparison the fused sequence kernel replaced.
Both are forward-only on every device, as the reference's are (reverse-mode
AD does not go through its ``pallas_call``): a call that needs a gradient
raises, on the CPU as on the card.

A CUDA tensor launches the kernels or raises; nothing falls back.  A
tensor on the ``meta`` device (the dry run's trace) takes
``torch.ops.repro_torch.lstm_sequence``, ``lstm_sequence_fwd_train``,
``lstm_sequence_bwd`` and ``lstm_cell`` (``kernels/_meta.py``) where the card
launches #1, #2, #3 and #5: the kernels' output shapes, and the FLOPs of
their plain versions' matrix products, 8 B H (F + H) a step forward and
16 B H (F + H) a step backward, times the streams.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels._meta import meta_kernel
from repro_torch.kernels.lstm_cell import kernel, ref


def _step_flops(x, wh, per_step: int) -> int:
    """``per_step`` B H (F + H) for every row and step of x (..., F), wh
    (..., H, 4H)."""
    return per_step * math.prod(x[:-1]) * wh[-2] * (x[-1] + wh[-2])


@meta_kernel("lstm_sequence(Tensor x, Tensor wx, Tensor wh, Tensor b) -> "
             "Tensor",
             lambda x, wx, wh, b, out_shape=None: _step_flops(x, wh, 8))
def _sequence_meta(x, wx, wh, b):
    return x.new_empty((*x.shape[:-2], wh.shape[-2]))


@meta_kernel("lstm_sequence_fwd_train(Tensor x, Tensor wx, Tensor wh, "
             "Tensor b) -> (Tensor, Tensor, Tensor)",
             lambda x, wx, wh, b, out_shape=None: _step_flops(x, wh, 8))
def _fwd_train_meta(x, wx, wh, b):
    H = wh.shape[-2]
    lead = x.shape[:-1]
    return (x.new_empty((*lead, 4 * H), dtype=torch.float32),
            x.new_empty((*lead, H), dtype=torch.float32),
            x.new_empty((*lead, H), dtype=torch.float32))


@meta_kernel("lstm_sequence_bwd(Tensor x, Tensor gates, Tensor c_seq, "
             "Tensor h_seq, Tensor wx, Tensor wh, Tensor dh, Tensor dc) -> "
             "(Tensor, Tensor, Tensor, Tensor)",
             lambda x, gates, c_seq, h_seq, wx, wh, dh, dc, out_shape=None:
             _step_flops(x, wh, 16))
def _bwd_meta(x, gates, c_seq, h_seq, wx, wh, dh, dc):
    f32 = torch.float32
    return (torch.empty_like(x, dtype=f32), torch.empty_like(wx, dtype=f32),
            torch.empty_like(wh, dtype=f32),
            wh.new_empty((*wh.shape[:-2], wh.shape[-1]), dtype=f32))


@meta_kernel("lstm_cell(Tensor x, Tensor h, Tensor c, Tensor wx, "
             "Tensor wh, Tensor b) -> (Tensor, Tensor)",
             lambda x, h, c, wx, wh, b, out_shape=None:
             _step_flops(x, wh, 8))
def _cell_meta(x, h, c, wx, wh, b):
    return torch.empty_like(h), torch.empty_like(c)


class _LSTMSequence(torch.autograd.Function):
    """x, wx, wh, b -> final hidden (B,H) in ``x.dtype``, differentiable in
    all four; with a stream axis, x (S,B,T,F) and stacked weights -> h
    (S,B,H), and the gradients per stream (S,F,4H), (S,H,4H), (S,4H).  Saves the residuals (post-activation gates, c_seq, h_seq, all
    float32) and the float32 weights, so the backward re-runs no product of
    the forward; the weights' gradients come back in the weights' types."""

    @staticmethod
    def forward(ctx, x, wx, wh, b):
        ctx.weight_dtypes = (wx.dtype, wh.dtype, b.dtype)
        wx, wh, b = kernel.f32_weights(wx, wh, b)
        if x.device.type == "cuda":
            gates, c_seq, h_seq = kernel.lstm_sequence_fwd_train(x, wx, wh, b)
        elif x.device.type == "meta":
            gates, c_seq, h_seq = _fwd_train_meta(x, wx, wh, b)
        else:
            gates, c_seq, h_seq = ref.lstm_sequence_fwd_train_ref(x, wx, wh, b)
        ctx.save_for_backward(x, gates, c_seq, h_seq, wx, wh)
        return h_seq[..., -1, :].to(dtype=x.dtype, copy=True)

    @staticmethod
    def backward(ctx, dh):
        x, gates, c_seq, h_seq, wx, wh = ctx.saved_tensors
        dh = dh.float().contiguous()
        dc = torch.zeros_like(dh)  # only the final h is an output
        bwd = {"cuda": kernel.lstm_sequence_bwd, "meta": _bwd_meta}.get(
            x.device.type, ref.lstm_sequence_bwd_ref)
        dx, dwx, dwh, db = bwd(x, gates, c_seq, h_seq, wx, wh, dh, dc)
        grads = (dx.to(x.dtype), *(g.to(dt) for g, dt in zip(
            (dwx, dwh, db), ctx.weight_dtypes)))
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def _check_device(name: str, x: torch.Tensor) -> None:
    if x.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def lstm_sequence(x: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Fused full-sequence LSTM: x (B,T,F) -> final hidden (B,H) in
    ``x.dtype``.  ``wx`` is (F,4H), ``wh`` (H,4H), ``b`` (4H) with gate order
    (i, f, g, o), float32 or bfloat16; compute is float32.  A fleet: x
    (S,B,T,F), wx (S,F,4H), wh (S,H,4H), b (S,4H) -> (S,B,H)."""
    _check_device("lstm_sequence", x)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, wx, wh, b)):
        return _LSTMSequence.apply(x, wx, wh, b)
    if x.device.type == "cuda":
        h, _ = kernel.lstm_sequence_fused(x, wx, wh, b)
        return h
    if x.device.type == "meta":
        return _sequence_meta(x, wx, wh, b)
    return ref.lstm_sequence_ref(x, wx, wh, b)


def _forward_only(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward-only: its kernel has no backward, as the "
            "reference's has none; differentiate ops.lstm_sequence instead")


def lstm_step(x_t: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor):
    """One LSTM step: x_t (B,F), h and c (B,H) -> (h', c'), h' in
    ``h.dtype`` and c' in ``c.dtype``; each input float32 or bfloat16,
    compute float32.  Forward-only."""
    _check_device("lstm_step", x_t)
    _forward_only("lstm_step", x_t, h, c, wx, wh, b)
    if x_t.device.type == "cuda":
        return kernel.lstm_cell(x_t, h, c, wx, wh, b)
    if x_t.device.type == "meta":
        return _cell_meta(x_t, h, c, wx, wh, b)
    return ref.lstm_cell_ref(x_t, h, c, wx, wh, b)


def lstm_sequence_scan(x: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """The per-step baseline: x (B,T,F) -> final hidden (B,H) in
    ``x.dtype``, one ``lstm_cell`` launch a timestep from h = c = 0, the
    carry in ``x.dtype`` (rounded every step in bfloat16, where the fused
    kernel keeps it in float32).  Forward-only."""
    _check_device("lstm_sequence_scan", x)
    _forward_only("lstm_sequence_scan", x, wx, wh, b)
    if x.device.type == "cpu":
        return ref.lstm_sequence_scan_ref(x, wx, wh, b)
    B, H = x.shape[0], wh.shape[0]
    cell = _cell_meta if x.device.type == "meta" else kernel.lstm_cell
    wx, wh, b = kernel.f32_weights(wx, wh, b)  # once, not at every step
    h = torch.zeros((B, H), dtype=x.dtype, device=x.device)
    c = torch.zeros_like(h)
    # one copy to (T,B,F), so that every step's slice is contiguous
    for x_t in x.transpose(0, 1).contiguous():
        h, c = cell(x_t, h, c, wx, wh, b)
    return h
