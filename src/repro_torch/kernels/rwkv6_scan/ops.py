"""Public entry point of the RWKV6 WKV scan: ``wkv``, in the model's layout.

The counterpart of the reference's ``kernels/rwkv6_scan/ops.py: wkv``,
which takes no initial state; this one carries one, as the model's
time-mix needs from prefill to every decode step.  A tensor on a CUDA
device launches the kernel (``kernel.rwkv6_scan``) or raises; a tensor on
the CPU takes its plain version (``ref.wkv_ref``).  Nothing falls back.

Under grad (grad mode on and an input requiring it) the call goes through
``WKV``, a ``torch.autograd.Function``: its forward is the same single
launch, and it saves the inputs; its backward launches the backward kernel
on the card (``kernel.rwkv6_scan_backward``) and takes the plain reverse
recurrence (``ref.wkv_bwd_ref``) on the CPU.  Without grad nothing is
saved.  ``out=`` is refused under grad: the kernel would write the final
state into the caller's tensor where autograd cannot see it.

A tensor on the ``meta`` device (the dry run's trace) takes
``torch.ops.repro_torch.wkv`` and, in the backward, ``wkv_backward``
(``kernels/_meta.py``): the kernels' output shapes, and the FLOPs of
``ref.wkv_ref`` (r_t against the state, 2 B T H N^2) and of
``ref.wkv_bwd_ref`` (three state products a step, 6 B T H N^2).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels._meta import meta_kernel
from repro_torch.kernels.rwkv6_scan import kernel, ref


@meta_kernel("wkv(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, "
             "Tensor? state0) -> (Tensor, Tensor)",
             lambda r, k, v, w, u, state0, out_shape=None:
             2 * math.prod(r) * r[-1])
def _wkv_meta(r, k, v, w, u, state0):
    B, _, H, N = r.shape
    return (torch.empty_like(r),
            r.new_empty((B, H, N, N), dtype=torch.float32))


@meta_kernel("wkv_backward(Tensor r, Tensor k, Tensor v, Tensor w, "
             "Tensor u, Tensor? state0, Tensor dy, Tensor? dstate) -> "
             "(Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)",
             lambda r, k, v, w, u, state0, dy, dstate, out_shape=None:
             6 * math.prod(r) * r[-1])
def _wkv_backward_meta(r, k, v, w, u, state0, dy, dstate):
    B, _, H, N = r.shape
    f32 = torch.float32
    return (*(torch.empty_like(r, dtype=f32) for _ in range(4)),
            torch.empty_like(u, dtype=f32),
            r.new_empty((B, H, N, N), dtype=f32))


def _forward(r, k, v, w, u, state0, out=None):
    """The forward on r's device: the kernel on CUDA, the oracle on the
    CPU."""
    if r.device.type == "cuda":
        return kernel.rwkv6_scan(
            *(t.contiguous() for t in (r, k, v, w, u)),
            None if state0 is None else state0.contiguous(), out=out)
    if r.device.type == "cpu":
        y, state = ref.wkv_ref(r, k, v, w, u, state0)
        return y, state if out is None else out.copy_(state)
    if r.device.type == "meta":
        y, state = _wkv_meta(r, k, v, w, u, state0)
        return y, state if out is None else out
    raise ValueError(f"wkv: unsupported device {r.device}")


class WKV(torch.autograd.Function):
    """The WKV scan with its gradient: r, k, v, w (B,T,H,N), u (H,N) and
    state0 (B,H,N,N) or None, float32 (contiguous on CUDA), in; (y, final
    state) out."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state0):
        y, state = _forward(r, k, v, w, u, state0)
        ctx.save_for_backward(r, k, v, w, u, state0)
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, w, u, state0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        if r.device.type == "cuda":
            return kernel.rwkv6_scan_backward(
                r, k, v, w, u, state0, dy.contiguous(),
                None if dstate is None else dstate.contiguous())
        bwd = (_wkv_backward_meta if r.device.type == "meta"
               else ref.wkv_bwd_ref)
        *grads, dstate0 = bwd(r, k, v, w, u, state0, dy, dstate)
        return (*grads, None if state0 is None else dstate0)


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, state0: Optional[torch.Tensor] = None, *,
        out: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (B,T,H,N) float32; u (H,N); state0 (B,H,N,N) float32 or
    None (zero) -> (y (B,T,H,N), state (B,H,N,N) float32).  The final
    state lands in ``out`` when it is given.  Under grad the call goes
    through ``WKV`` (module docstring)."""
    inputs = [t for t in (r, k, v, w, u, state0) if t is not None]
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in inputs)):
        return _forward(r, k, v, w, u, state0, out)
    if out is not None:
        raise ValueError("wkv: out= has no gradient; under grad the final "
                         "state comes back as a fresh tensor (out=None)")
    if r.device.type == "cuda":
        # views after the projections' reshape are copied once, here; the
        # copies' gradients flow back to the views
        r, k, v, w, u = (t.contiguous() for t in (r, k, v, w, u))
        state0 = None if state0 is None else state0.contiguous()
    return WKV.apply(r, k, v, w, u, state0)
