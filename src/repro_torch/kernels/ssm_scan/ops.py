"""Public entry point of the Mamba2 selective scan: ``selective_scan``, in
the model's layout.

The counterpart of the reference's ``kernels/ssm_scan/ops.py:
selective_scan``, which starts from a zero state and broadcasts the one
group's b and c to every head before the kernel; this one carries a state,
as the Mamba2 mixer needs from prefill to every decode step, and hands b
and c (B,T,N) to the kernel as they are.  A tensor on a CUDA device
launches the kernel (``kernel.ssm_scan``) or raises; a tensor on the CPU
takes its plain version (``ref.selective_scan_ref``).  Nothing falls back.

Under grad (grad mode on and an input requiring it) the call goes through
``SelectiveScan``, a ``torch.autograd.Function``: its forward is the same
single launch, and it saves the inputs; its backward launches the backward
kernel on the card (``kernel.ssm_scan_backward``) and takes the plain
reverse recurrence (``ref.selective_scan_bwd_ref``) on the CPU.  Without
grad nothing is saved.  ``out=`` is refused under grad: the kernel would
write the final state into the caller's tensor where autograd cannot see
it.

A tensor on the ``meta`` device (the dry run's trace) takes
``torch.ops.repro_torch.selective_scan`` and, in the backward,
``selective_scan_backward`` (``kernels/_meta.py``): the kernels' output
shapes, and the FLOPs of ``ref.selective_scan_ref`` (the state against
c_t, 2 B T H P N) and of ``ref.selective_scan_bwd_ref`` (three state
products a step, 6 B T H P N).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels._meta import meta_kernel
from repro_torch.kernels.ssm_scan import kernel, ref


@meta_kernel("selective_scan(Tensor x, Tensor b, Tensor c, Tensor dt, "
             "Tensor a, Tensor d, Tensor? state0) -> (Tensor, Tensor)",
             lambda x, b, c, dt, a, d, state0, out_shape=None:
             2 * math.prod(x) * b[-1])
def _scan_meta(x, b, c, dt, a, d, state0):
    B, _, H, P = x.shape
    return (torch.empty_like(x),
            x.new_empty((B, H, P, b.shape[-1]), dtype=torch.float32))


@meta_kernel("selective_scan_backward(Tensor x, Tensor b, Tensor c, "
             "Tensor dt, Tensor a, Tensor d, Tensor? state0, Tensor dy, "
             "Tensor? dstate) -> (Tensor, Tensor, Tensor, Tensor, Tensor, "
             "Tensor, Tensor)",
             lambda x, b, c, dt, a, d, state0, dy, dstate, out_shape=None:
             6 * math.prod(x) * b[-1])
def _scan_backward_meta(x, b, c, dt, a, d, state0, dy, dstate):
    B, _, H, P = x.shape
    f32 = torch.float32
    return (*(torch.empty_like(t, dtype=f32) for t in (x, b, c, dt, a, d)),
            x.new_empty((B, H, P, b.shape[-1]), dtype=f32))


def _forward(x, b, c, dt, a, d, state0, out=None):
    """The forward on x's device: the kernel on CUDA, the oracle on the
    CPU."""
    if x.device.type == "cuda":
        return kernel.ssm_scan(
            *(t.contiguous() for t in (x, b, c, dt, a, d)),
            None if state0 is None else state0.contiguous(), out=out)
    if x.device.type == "cpu":
        y, state = ref.selective_scan_ref(x, b, c, dt, a, d, state0)
        return y, state if out is None else out.copy_(state)
    if x.device.type == "meta":
        y, state = _scan_meta(x, b, c, dt, a, d, state0)
        return y, state if out is None else out
    raise ValueError(f"selective_scan: unsupported device {x.device}")


class SelectiveScan(torch.autograd.Function):
    """The selective scan with its gradient: x (B,T,H,P), b, c (B,T,N), dt
    (B,T,H), a, d (H,) and state0 (B,H,P,N) or None, float32 (contiguous
    on CUDA), in; (y, final state) out."""

    @staticmethod
    def forward(ctx, x, b, c, dt, a, d, state0):
        y, state = _forward(x, b, c, dt, a, d, state0)
        ctx.save_for_backward(x, b, c, dt, a, d, state0)
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, b, c, dt, a, d, state0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        if x.device.type == "cuda":
            return kernel.ssm_scan_backward(
                x, b, c, dt, a, d, state0, dy.contiguous(),
                None if dstate is None else dstate.contiguous())
        bwd = (_scan_backward_meta if x.device.type == "meta"
               else ref.selective_scan_bwd_ref)
        *grads, dstate0 = bwd(x, b, c, dt, a, d, state0, dy, dstate)
        return (*grads, None if state0 is None else dstate0)


def selective_scan(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   dt: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                   state0: Optional[torch.Tensor] = None, *,
                   out: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,T,H,P) float32; b, c (B,T,N); dt (B,T,H); a, d (H,); state0
    (B,H,P,N) float32 or None (zero) -> (y (B,T,H,P), state (B,H,P,N)
    float32), y_t = h_t c_t + d x_t.  The final state lands in ``out``
    when it is given.  Under grad the call goes through ``SelectiveScan``
    (module docstring)."""
    inputs = [t for t in (x, b, c, dt, a, d, state0) if t is not None]
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in inputs)):
        return _forward(x, b, c, dt, a, d, state0, out)
    if out is not None:
        raise ValueError("selective_scan: out= has no gradient; under grad "
                         "the final state comes back as a fresh tensor "
                         "(out=None)")
    if x.device.type == "cuda":
        # views after the splits and reshapes are copied once, here; the
        # copies' gradients flow back to the views
        x, b, c, dt, a, d = (t.contiguous() for t in (x, b, c, dt, a, d))
        state0 = None if state0 is None else state0.contiguous()
    return SelectiveScan.apply(x, b, c, dt, a, d, state0)
