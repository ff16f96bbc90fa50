"""The plain PyTorch versions of flash attention: the CPU path of
``ops.gqa_flash`` and ``ops.flash_attend``, and the functions the kernel is
held to on the card.  Both materialize the score matrix, so they are for
checks and small shapes.

``attend_full_ref`` is the positions form, the counterpart of the
reference's ``models/attention.py: attend_full_ref``: q (B,Sq,Hq,D), k and
v (B,Sk,Hkv,D), ``kv_pos`` -1 on an unwritten slot.  ``attention_ref`` is
the counterpart of ``kernels/flash_attention/ref.py: attention_ref``, the
(B,H,S,D) layout with arange positions.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def position_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
                  window: int) -> torch.Tensor:
    """(B,Sq,Sk) bool: a slot counts when it is written (``kv_pos >= 0``),
    not after the query when ``causal``, and less than ``window`` behind
    it when ``window > 0``."""
    kp, qp = kv_pos[:, None, :], q_pos[:, :, None]
    mask = kp >= 0
    if causal:
        mask = mask & (kp <= qp)
    if window > 0:
        mask = mask & ((qp - kp) < window)
    return mask


def attend_full_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Grouped-query attention over explicit positions, in float32; returns
    (B,Sq,Hq,D) in ``q.dtype``.  A row with no slot to attend gives 0."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = D**-0.5 if scale is None else scale
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg, k.float()) * scale
    mask = position_mask(q_pos, kv_pos, causal, window)[:, :, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.softmax(s, dim=-1), 0.0)
    out = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def arange_positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q, k, v: (B,H,S,D), one KV head per query head, positions 0..S-1."""
    B, Sq, Sk = q.shape[0], q.shape[2], k.shape[2]
    out = attend_full_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        arange_positions(B, Sq, q.device), arange_positions(B, Sk, q.device),
        causal=causal, window=window)
    return out.transpose(1, 2)
