"""The plain PyTorch versions of the RWKV6 WKV scan: the CPU path of
``ops.wkv`` and the functions the kernel is held to on the card.

Per (batch, head), head size N, from the state S_0 (zero unless given):

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

``wkv_ref`` is the model layout, r, k, v, w (B,T,H,N) and u (H,N);
``rwkv6_scan_ref`` is the counterpart of the reference's
``kernels/rwkv6_scan/ref.py: rwkv6_scan_ref``, the flat (BH,T,N) layout
with u (BH,N): the model layout's BH heads of one batch row.  Both step through time one token at a time
in float32 and return y in r's dtype and the final state in float32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor,
            state0: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (B,T,H,N); u (H,N); state0 (B,H,N,N) -> (y (B,T,H,N),
    state (B,H,N,N) float32)."""
    B, T, H, N = r.shape
    S = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float())
    uf = u.float()[..., None]  # (H,N,1)
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    ys = []
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]  # (B,H,N,N)
        ys.append(torch.einsum("bhn,bhnm->bhm", rf[:, t], S + uf * kv))
        S = wf[:, t, :, :, None] * S + kv
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros((B, 0, H, N), dtype=torch.float32, device=r.device))
    return y.to(r.dtype), S


def to_model_layout(x: torch.Tensor) -> torch.Tensor:
    """(BH,T,N) -> (1,T,BH,N), contiguous: BH heads of one batch row."""
    return x.transpose(0, 1)[None].contiguous()


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor,
                   state0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (BH,T,N); u (BH,N); state0 (BH,N,N) -> (y (BH,T,N),
    state (BH,N,N) float32): ``wkv_ref`` on ``to_model_layout``."""
    y, S = wkv_ref(*map(to_model_layout, (r, k, v, w)), u,
                   None if state0 is None else state0[None])
    return y[0].transpose(0, 1), S[0]
