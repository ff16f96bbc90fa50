"""Public entry point of the RWKV6 WKV scan: ``wkv``, in the model's layout.

The counterpart of the reference's ``kernels/rwkv6_scan/ops.py: wkv``,
which takes no initial state; this one carries one, as the model's
time-mix needs from prefill to every decode step.  A tensor on a CUDA
device launches the kernel (``kernel.rwkv6_scan``) or raises; a tensor on
the CPU takes its plain version (``ref.wkv_ref``).  Nothing falls back.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.rwkv6_scan import kernel, ref


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, state0: Optional[torch.Tensor] = None, *,
        out: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (B,T,H,N) float32; u (H,N); state0 (B,H,N,N) float32 or
    None (zero) -> (y (B,T,H,N), state (B,H,N,N) float32).  The final
    state lands in ``out`` when it is given."""
    if r.device.type == "cuda":
        return kernel.rwkv6_scan(
            *(t.contiguous() for t in (r, k, v, w, u)),
            None if state0 is None else state0.contiguous(), out=out)
    if r.device.type == "cpu":
        y, state = ref.wkv_ref(r, k, v, w, u, state0)
        return y, state if out is None else out.copy_(state)
    raise ValueError(f"wkv: unsupported device {r.device}")
