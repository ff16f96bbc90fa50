"""Public entry point of the Mamba2 selective scan: ``selective_scan``, in
the model's layout.

The counterpart of the reference's ``kernels/ssm_scan/ops.py:
selective_scan``, which starts from a zero state and broadcasts the one
group's b and c to every head before the kernel; this one carries a state,
as the Mamba2 mixer needs from prefill to every decode step, and hands b
and c (B,T,N) to the kernel as they are.  A tensor on a CUDA device
launches the kernel (``kernel.ssm_scan``) or raises; a tensor on the CPU
takes its plain version (``ref.selective_scan_ref``).  Nothing falls back.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssm_scan import kernel, ref


def selective_scan(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   dt: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                   state0: Optional[torch.Tensor] = None, *,
                   out: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,T,H,P) float32; b, c (B,T,N); dt (B,T,H); a, d (H,); state0
    (B,H,P,N) float32 or None (zero) -> (y (B,T,H,P), state (B,H,P,N)
    float32), y_t = h_t c_t + d x_t.  The final state lands in ``out``
    when it is given."""
    if x.device.type == "cuda":
        return kernel.ssm_scan(
            *(t.contiguous() for t in (x, b, c, dt, a, d)),
            None if state0 is None else state0.contiguous(), out=out)
    if x.device.type == "cpu":
        y, state = ref.selective_scan_ref(x, b, c, dt, a, d, state0)
        return y, state if out is None else out.copy_(state)
    raise ValueError(f"selective_scan: unsupported device {x.device}")
