"""The plain PyTorch versions of the Mamba2 selective scan: the CPU path of
``ops.selective_scan`` and the functions the kernel is held to on the card.

Per (batch, head), head dim P and state dim N, with a scalar decay a and a
scalar skip d per head, from the state h_0 (zero unless given):

    h_t = exp(dt_t a) h_{t-1} + (dt_t x_t) b_t^T
    y_t = h_t c_t + d x_t

``selective_scan_ref`` is the model layout: x (B,T,H,P), b and c (B,T,N)
(one group, shared by every head), dt (B,T,H), a and d (H,).
``ssm_scan_ref`` is the counterpart of the reference's
``kernels/ssm_scan/ref.py: ssm_scan_ref``, the flat layout: x (BH,T,P), b
and c (BH,T,N), dt (BH,T), a and d (BH,), each row one head of its own
batch row.  Both step through time one token at a time in float32 and
return y in x's dtype and the final state in float32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _scan(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
          dt: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
          h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,T,H,P), b and c (B,T,N), dt (B,T,H) float32; a and d
    broadcastable to (B,H); h (B,H,P,N) float32 -> (y (B,T,H,P), h)."""
    ys = []
    for t in range(x.shape[1]):
        dtt = dt[:, t]  # (B,H)
        decay = torch.exp(dtt * a)
        upd = (dtt[..., None] * x[:, t])[..., None] * b[:, t, None, None, :]
        h = decay[..., None, None] * h + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, c[:, t])
                  + d[..., None] * x[:, t])
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros(x.shape, dtype=torch.float32, device=x.device))
    return y, h


def selective_scan_ref(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                       dt: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                       state0: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,T,H,P); b, c (B,T,N); dt (B,T,H); a, d (H,); state0
    (B,H,P,N) -> (y (B,T,H,P), state (B,H,P,N) float32)."""
    B, T, H, P = x.shape
    N = b.shape[-1]
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if state0 is None else state0.float())
    y, h = _scan(*(t.float() for t in (x, b, c, dt, a, d)), h)
    return y.to(x.dtype), h


def ssm_scan_ref(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 dt: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                 state0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (BH,T,P); b, c (BH,T,N); dt (BH,T); a, d (BH,); state0 (BH,P,N)
    -> (y (BH,T,P), state (BH,P,N) float32): each row a batch row of one
    head of its own (a, d), the model layout's one-head case."""
    BH, T, P = x.shape
    N = b.shape[-1]
    h = (torch.zeros((BH, 1, P, N), dtype=torch.float32, device=x.device)
         if state0 is None else state0.float()[:, None])
    y, h = _scan(x.float()[:, :, None], b.float(), c.float(),
                 dt.float()[..., None], a.float()[:, None],
                 d.float()[:, None], h)
    return y[:, :, 0].to(x.dtype), h[:, 0]
