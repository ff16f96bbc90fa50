"""The plain PyTorch version of the fused sequence kernel: the same function,
one step at a time.  The CPU path of ``ops.lstm_sequence`` and the reference
the kernel is held to on the card."""
from __future__ import annotations

import torch


def lstm_sequence_ref(x: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor,
                      b: torch.Tensor, return_state: bool = False):
    """x (B,T,F) -> final hidden (B,H), or the final ``(h, c)`` with
    ``return_state=True``.  As in the kernel, compute and the h/c carry are
    float32 and only the final state is cast to ``x.dtype``."""
    B, T, _ = x.shape
    H = wh.shape[0]
    xf, wx, wh, b = x.float(), wx.float(), wh.float(), b.float()
    h = torch.zeros((B, H), dtype=torch.float32, device=x.device)
    c = torch.zeros((B, H), dtype=torch.float32, device=x.device)
    for t in range(T):
        z = xf[:, t] @ wx + h @ wh + b
        i, f, g, o = z.split(H, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c = f * c + i * torch.tanh(g)
        h = o * torch.tanh(c)
    h, c = h.to(x.dtype), c.to(x.dtype)
    return (h, c) if return_state else h
