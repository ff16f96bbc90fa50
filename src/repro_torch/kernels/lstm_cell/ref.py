"""The plain PyTorch versions of the LSTM kernels: the same functions, one
step at a time.  The CPU path of ``ops`` and the reference each kernel is
held to on the card."""
from __future__ import annotations

from typing import Iterator, Tuple

import torch


def lstm_cell_ref(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                  wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step: x (B,F), h and c (B,H), each input float32 or bfloat16 ->
    (h', c').  z = x·wx + h·wh + b in float32, gate order i, f, g, o;
    c' = f·c + i·g with c read as float32, h' = o·tanh(c'); h' comes back in
    ``h.dtype`` and c' in ``c.dtype``."""
    H = h.shape[-1]
    z = x.float() @ wx.float() + h.float() @ wh.float() + b.float()
    i, f, g, o = z.split(H, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c_new = f * c.float() + i * torch.tanh(g)
    h_new = o * torch.tanh(c_new)
    return h_new.to(h.dtype), c_new.to(c.dtype)


def lstm_sequence_scan_ref(x: torch.Tensor, wx: torch.Tensor,
                           wh: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The per-step scan: x (B,T,F) -> final hidden (B,H) in ``x.dtype``,
    ``lstm_cell_ref`` a step from h = c = 0.  Unlike ``lstm_sequence_ref``
    the h/c carry is in ``x.dtype``, so in bfloat16 it rounds every step, as
    the reference's ``lstm_sequence_scan`` carries it."""
    B, T, _ = x.shape
    h = torch.zeros((B, wh.shape[0]), dtype=x.dtype, device=x.device)
    c = torch.zeros_like(h)
    for t in range(T):
        h, c = lstm_cell_ref(x[:, t], h, c, wx, wh, b)
    return h


def _steps(x: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor,
           b: torch.Tensor) -> Iterator[Tuple[torch.Tensor, ...]]:
    """The forward recurrence in float32 from h = c = 0: yields the
    post-activation gates (i, f, g, o) and the new (c, h) of every step."""
    B, T, _ = x.shape
    H = wh.shape[0]
    xf, wx, wh, b = x.float(), wx.float(), wh.float(), b.float()
    h = torch.zeros((B, H), dtype=torch.float32, device=x.device)
    c = torch.zeros((B, H), dtype=torch.float32, device=x.device)
    for t in range(T):
        z = xf[:, t] @ wx + h @ wh + b
        i, f, g, o = z.split(H, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        g = torch.tanh(g)
        c = f * c + i * g
        h = o * torch.tanh(c)
        yield i, f, g, o, c, h


def lstm_sequence_ref(x: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor,
                      b: torch.Tensor, return_state: bool = False):
    """x (B,T,F) -> final hidden (B,H), or the final ``(h, c)`` with
    ``return_state=True``.  As in the kernel, compute and the h/c carry are
    float32 and only the final state is cast to ``x.dtype``."""
    for *_, c, h in _steps(x, wx, wh, b):
        pass
    h, c = h.to(x.dtype), c.to(x.dtype)
    return (h, c) if return_state else h


def lstm_sequence_fwd_train_ref(x: torch.Tensor, wx: torch.Tensor,
                                wh: torch.Tensor, b: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """x (B,T,F) -> the backward's residuals: post-activation gates
    (B,T,4H) in the order i, f, g, o, and c_seq, h_seq (B,T,H), all
    float32."""
    gates, cs, hs = [], [], []
    for i, f, g, o, c, h in _steps(x, wx, wh, b):
        gates.append(torch.cat([i, f, g, o], dim=-1))
        cs.append(c)
        hs.append(h)
    return torch.stack(gates, 1), torch.stack(cs, 1), torch.stack(hs, 1)


def lstm_sequence_bwd_ref(x: torch.Tensor, gates: torch.Tensor,
                          c_seq: torch.Tensor, h_seq: torch.Tensor,
                          wx: torch.Tensor, wh: torch.Tensor,
                          dh: torch.Tensor, dc: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
    """The reverse-time VJP from the residuals and the cotangents dh, dc
    (B,H) of the final (h, c): returns dx (B,T,F), dwx (F,4H), dwh (H,4H)
    and db (4H), all float32.  h_prev and c_prev are zero at t = 0."""
    B, T, F = x.shape
    H = wh.shape[0]
    xf, wx, wh = x.float(), wx.float(), wh.float()
    dh, dc = dh.float(), dc.float()
    zeros = torch.zeros((B, H), dtype=torch.float32, device=x.device)
    dx = torch.zeros((B, T, F), dtype=torch.float32, device=x.device)
    dwx, dwh = torch.zeros_like(wx), torch.zeros_like(wh)
    db = torch.zeros((4 * H,), dtype=torch.float32, device=x.device)
    for t in reversed(range(T)):
        i, f, g, o = gates[:, t].split(H, dim=-1)
        c_prev = c_seq[:, t - 1] if t > 0 else zeros
        h_prev = h_seq[:, t - 1] if t > 0 else zeros
        tanh_c = torch.tanh(c_seq[:, t])
        do = dh * tanh_c
        dct = dc + dh * o * (1.0 - tanh_c * tanh_c)
        dz = torch.cat([dct * g * i * (1.0 - i),
                        dct * c_prev * f * (1.0 - f),
                        dct * i * (1.0 - g * g),
                        do * o * (1.0 - o)], dim=-1)
        dwx = dwx + xf[:, t].T @ dz
        dwh = dwh + h_prev.T @ dz
        db = db + dz.sum(0)
        dx[:, t] = dz @ wx.T
        dh = dz @ wh.T
        dc = dct * f
    return dx, dwx, dwh, db
