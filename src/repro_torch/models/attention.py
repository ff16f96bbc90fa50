"""Grouped-query attention over explicit positions: ``attend``.

On the card every call is the hand-written flash kernel
(``kernels.flash_attention.ops.flash_attend``): it never materializes the
(Sq, Sk) score matrix and keeps the flash-style running (max, sum, acc)
statistics in f32.  On the CPU ``attend`` is a port of the reference's
chunked online-softmax scan, which the reference's Pallas kernel is "the
TPU-optimized version of", and ``attend_full_ref`` the O(Sq*Sk) oracle
both are held to.

Positions are explicit: ``kv_pos`` carries -1 for invalid (unwritten cache)
slots, which uniformly handles causal masks, sliding windows, ring-buffer
caches and padded chunks.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    NEG_INF,
    attend_full_ref,
    position_mask,
)


def _pad_to_multiple(x: torch.Tensor, mult: int, axis: int,
                     pad_value=0) -> torch.Tensor:
    rem = (-x.shape[axis]) % mult
    if rem == 0:
        return x
    pads = [0, 0] * (x.dim() - 1 - axis) + [0, rem]
    return F.pad(x, pads, value=pad_value)


def attend(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    q_pos: torch.Tensor,  # (B, Sq) int32
    kv_pos: torch.Tensor,  # (B, Sk) int32; -1 marks invalid slots
    *,
    causal: bool = True,
    window: int = 0,  # >0 -> sliding window of this width
    chunk: int = 1024,
    scale: Optional[float] = None,
    p_dtype: Optional[torch.dtype] = None,  # prob dtype for the PV product
) -> torch.Tensor:
    """Grouped-query attention; returns (B, Sq, Hq, D) in q.dtype.

    On a CUDA device: the flash kernels, which tile on their own
    (``chunk`` is the CPU scan's KV chunk and is not read); p stays in
    float32, or with ``p_dtype`` bfloat16 p and v are rounded to bf16 before
    the P V product, accumulated in f32, as the reference's.  Under grad
    (q, k or v requiring it) the call goes through
    ``flash_ops.FlashAttend``, whose backward is #6's two backward
    kernels; p_dtype bfloat16 has no backward and raises there.  Without
    grad it is the single forward launch and saves nothing.  On the CPU:
    the chunked scan, ``chunk`` keys a step, differentiated by autograd as
    the reference's scan is by XLA.  On the ``meta`` device: the card's
    path, through ``flash_ops``' meta branch."""
    if q.device.type in ("cuda", "meta"):
        return flash_ops.flash_attend(q, k, v, q_pos, kv_pos, causal=causal,
                                      window=window, scale=scale,
                                      p_dtype=p_dtype)
    if q.device.type != "cpu":
        raise ValueError(f"attend: unsupported device {q.device}")
    return _attend_chunked(q, k, v, q_pos, kv_pos, causal=causal,
                           window=window, chunk=chunk, scale=scale,
                           p_dtype=p_dtype)


def _attend_chunked(q, k, v, q_pos, kv_pos, *, causal, window, chunk, scale,
                    p_dtype):
    """The reference's scan over KV chunks, step for step."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"attend: Hq={Hq} is not a multiple of Hkv={Hkv}")
    G = Hq // Hkv
    scale = D**-0.5 if scale is None else scale

    qg = q.reshape(B, Sq, Hkv, G, D).float()
    chunk = min(chunk, Sk)
    kp = _pad_to_multiple(k, chunk, axis=1)
    vp = _pad_to_multiple(v, chunk, axis=1)
    pp = _pad_to_multiple(kv_pos, chunk, axis=1, pad_value=-1)
    n_chunks = kp.shape[1] // chunk

    m = torch.full((B, Sq, Hkv, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Sq, Hkv, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, Hkv, G, D), dtype=torch.float32,
                      device=q.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        kk, vv, pos = kp[:, sl], vp[:, sl], pp[:, sl]
        # scores: (B, Sq, Hkv, G, C) in f32
        s = torch.einsum("bqhgd,bchd->bqhgc", qg, kk.float()) * scale
        mask = position_mask(q_pos, pos, causal, window)[:, :, None, None, :]
        s = torch.where(mask, s, NEG_INF)

        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows: keep m finite for exp
        m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        corr = torch.exp(torch.where(m <= NEG_INF / 2, NEG_INF, m) - m_safe)
        corr = torch.where(m <= NEG_INF / 2, 0.0, corr)
        l = l * corr + p.sum(dim=-1)
        if p_dtype is not None:
            # halve P-matrix traffic; accumulate in f32 regardless
            pv = torch.einsum("bqhgc,bchd->bqhgd", p.to(p_dtype).float(),
                              vv.to(p_dtype).float())
        else:
            pv = torch.einsum("bqhgc,bchd->bqhgd", p, vv.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Sq, Hq, D).to(q.dtype)
