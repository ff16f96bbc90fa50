"""The plain PyTorch versions of flash attention: the CPU path of
``ops.gqa_flash`` and ``ops.flash_attend``, and the functions the kernel is
held to on the card.  Both materialize the score matrix, so they are for
checks and small shapes.

``attend_full_ref`` is the positions form, the counterpart of the
reference's ``models/attention.py: attend_full_ref``: q (B,Sq,Hq,D), k and
v (B,Sk,Hkv,D), ``kv_pos`` -1 on an unwritten slot.  ``attention_ref`` is
the counterpart of ``kernels/flash_attention/ref.py: attention_ref``, the
(B,H,S,D) layout with arange positions.

Two more compute the same function by the algorithms of the card's
kernels, so that the CPU tests can hold each algorithm to the reference:
``flash_decode_split_ref`` is the split decode's (per-split statistics,
then the combine in split order), ``attend_tc_ref`` the tensor-core
prefill's (bf16 operands, P applied as P_hi + P_lo in bf16).

``flash_attend_bwd_ref`` is the gradient's plain version: the closed-form
(dq, dk, dv) of ``attend_full_ref`` from the same O(Sq*Sk) oracle, the CPU
path of ``ops.flash_attend``'s backward and what the card's backward
kernels are held to.  ``flash_attend_bwd_tc_ref`` computes the same
gradient in the tensor-core backward's rounding (bf16 operands, P and dS
applied as hi + lo bf16 parts), for the CPU tests and the card's
diagnostics.
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
    mask = (kp >= 0).expand(-1, qp.shape[1], -1)
    if causal:
        mask = mask & (kp <= qp)
    if window > 0:
        mask = mask & ((qp - kp) < window)
    return mask


def attend_full_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None,
                    p_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Grouped-query attention over explicit positions, in float32; returns
    (B,Sq,Hq,D) in ``q.dtype``.  A row with no slot to attend gives 0.
    ``p_dtype`` rounds the probabilities and v to it before p v."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = D**-0.5 if scale is None else scale
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg, k.float()) * scale
    mask = position_mask(q_pos, kv_pos, causal, window)[:, :, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.softmax(s, dim=-1), 0.0)
    vf = v.float()
    if p_dtype is not None:
        p, vf = p.to(p_dtype).float(), v.to(p_dtype).float()
    out = torch.einsum("bqhgk,bkhd->bqhgd", p, vf)
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def flash_attend_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         o: torch.Tensor, do: torch.Tensor,
                         q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         scale: Optional[float] = None):
    """(dq, dk, dv) of ``attend_full_ref`` (p in float32) whose output was
    ``o``, for the output's gradient ``do``, in float32 and returned in the
    inputs' dtypes: P recomputed, dP = dO V^T, delta = rowsum(dO * O) of
    the given ``o`` (as the kernel reads the forward's own), dS = P (dP -
    delta), dq = scale dS K, dk = scale dS^T q and dv = P^T dO, each KV
    head's summed over its group's G query heads.  A row with no slot to
    attend has P = 0, so zero gradient."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = D**-0.5 if scale is None else scale
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    dog = do.reshape(B, Sq, Hkv, G, D).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg, kf) * scale
    mask = position_mask(q_pos, kv_pos, causal, window)[:, :, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.softmax(s, dim=-1), 0.0)
    dp = torch.einsum("bqhgd,bkhd->bqhgk", dog, vf)
    delta = (dog * o.reshape(B, Sq, Hkv, G, D).float()).sum(-1)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bqhgk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bqhgk,bqhgd->bkhd", ds, qg) * scale
    dv = torch.einsum("bqhgk,bqhgd->bkhd", p, dog)
    return (dq.reshape(B, Sq, Hq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def bf16_hi_lo(x: torch.Tensor):
    """float32 ``x`` as the tensor-core kernels feed it to a bf16 product:
    hi = x cut to its top 16 bits (a bf16 value, by a byte permute), lo =
    bf16(x - hi) rounded to nearest; hi + lo carries x to ~2^-16 of
    itself."""
    hi = (x.contiguous().view(torch.int32) & -65536).view(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).float()


def flash_attend_bwd_tc_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, q_pos: torch.Tensor,
                            kv_pos: torch.Tensor, *, causal: bool = True,
                            window: int = 0,
                            scale: Optional[float] = None):
    """(dq, dk, dv) of ``attend_full_ref`` by the arithmetic of the
    tensor-core backward (``csrc/flash_backward_wgmma.cu``): q, k, v and
    dO, the products' operands, rounded to bf16 (o as given: the kernels
    read the forward's own bf16 output for delta); S = q K^T and dP = dO
    V^T the bf16 products summed in float32; lse = log sum exp of the masked, scaled S (the
    kernels' m + log l); P = exp(S scale - lse), delta = rowsum(dO * O), dS = P (dP - delta), all
    float32; then dq = scale dS K, dk = scale dS^T q and dv = P^T dO with P
    and dS applied as their ``bf16_hi_lo`` parts against bf16 operands,
    summed in float32.  A row with no slot to attend has zero gradient.
    Returned in float32 (the kernels round once more, to bf16, on
    store)."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = D**-0.5 if scale is None else scale

    def bf(t, *shape):
        return t.to(torch.bfloat16).float().reshape(*shape)

    qg, dog = (bf(t, B, Sq, Hkv, G, D) for t in (q, do))
    og = o.float().reshape(B, Sq, Hkv, G, D)
    kf, vf = bf(k, k.shape), bf(v, v.shape)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg, kf) * scale
    mask = position_mask(q_pos, kv_pos, causal, window)[:, :, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - lse), 0.0)
    dp = torch.einsum("bqhgd,bkhd->bqhgk", dog, vf)
    delta = (dog * og).sum(-1)
    ds = p * (dp - delta[..., None])

    def tc(eq, x, y):  # x as hi + lo against the bf16 operand y
        hi, lo = bf16_hi_lo(x)
        return torch.einsum(eq, hi, y) + torch.einsum(eq, lo, y)

    dq = tc("bqhgk,bkhd->bqhgd", ds, kf) * scale
    dk = tc("bqhgk,bqhgd->bkhd", ds, qg) * scale
    dv = tc("bqhgk,bqhgd->bkhd", p, dog)
    return dq.reshape(B, Sq, Hq, D), dk, dv


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


def _scores(qg, kk, q_pos, pos, causal, window, scale):
    """Masked f32 scores (B,Sq,Hkv,G,C) of a run of keys, and the mask."""
    s = torch.einsum("bqhgd,bchd->bqhgc", qg, kk) * scale
    mask = position_mask(q_pos, pos, causal, window)[:, :, None, None, :]
    return torch.where(mask, s, NEG_INF), mask


def flash_decode_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                           causal: bool = True, window: int = 0,
                           scale: Optional[float] = None, split: int = 64,
                           p_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """The split decode's algorithm (``csrc/flash_decode.cu``): for each
    run of ``split`` keys the partial statistics in f32 -- m the run's
    largest score (-1e30 where the row attends no slot of it), l = sum p,
    acc = p v with p = exp(s - m) -- then the combine in split order:
    o = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30), M the
    largest m_s, splits without a slot left out; a row with none gives 0.
    With ``p_dtype`` p and v are rounded to it before p v (l keeps the f32
    p).  Returns (B,Sq,Hq,D) in ``q.dtype``."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = D**-0.5 if scale is None else scale
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    out = torch.zeros((B, Sq, Hkv, G, D), dtype=torch.float32,
                      device=q.device)
    parts = []
    for k0 in range(0, Sk, split):
        kk, vv = k[:, k0:k0 + split].float(), v[:, k0:k0 + split].float()
        s, mask = _scores(qg, kk, q_pos, kv_pos[:, k0:k0 + split], causal,
                          window, scale)
        m = s.amax(dim=-1)
        empty = m <= NEG_INF / 2
        p = torch.where(mask, torch.exp(s - torch.where(empty, 0.0, m)[
            ..., None]), 0.0)
        pv = p if p_dtype is None else p.to(p_dtype).float()
        vv = vv if p_dtype is None else vv.to(p_dtype).float()
        parts.append((torch.where(empty, NEG_INF, m), p.sum(dim=-1),
                      torch.einsum("bqhgc,bchd->bqhgd", pv, vv)))
    if not parts:
        return out.reshape(B, Sq, Hq, D).to(q.dtype)
    M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    dead = M <= NEG_INF / 2
    M = torch.where(dead, 0.0, M)
    L = torch.zeros_like(M)
    for m, l, acc in parts:  # in split order
        w = torch.where(m > NEG_INF / 2, torch.exp(m - M), 0.0)
        L = L + l * w
        out = out + acc * w[..., None]
    out = torch.where(dead[..., None], 0.0,
                      out / torch.clamp(L, min=1e-30)[..., None])
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def attend_tc_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale: Optional[float] = None, tile: int = 64,
                  p_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The tensor-core prefill's algorithm (``csrc/flash_prefill.cu``):
    q, k and v rounded to bf16; per tile of ``tile`` keys the f32 scores
    (the bf16 products summed in f32) and the online-softmax update in f32;
    P applied as P_hi + P_lo against bf16 V, accumulated in f32: P_hi is P
    cut to its top 16 bits (a bf16 value), P_lo = bf16(P - P_hi), so the
    two carry P to ~2^-16 of itself (``p_dtype`` bfloat16: bf16(P) alone,
    rounded to nearest, the reference's ``attend(p_dtype=bfloat16)``).
    Returns (B,Sq,Hq,D) in ``q.dtype``."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = D**-0.5 if scale is None else scale
    bf = torch.bfloat16
    qg = q.reshape(B, Sq, Hkv, G, D).to(bf).float()
    m = torch.full((B, Sq, Hkv, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Sq, Hkv, G, D), dtype=torch.float32,
                      device=q.device)
    for k0 in range(0, Sk, tile):
        kk = k[:, k0:k0 + tile].to(bf).float()
        vv = v[:, k0:k0 + tile].to(bf).float()
        s, mask = _scores(qg, kk, q_pos, kv_pos[:, k0:k0 + tile], causal,
                          window, scale)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        corr = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_safe))
        l = l * corr + p.sum(dim=-1)
        if p_dtype is None:
            p_hi = (p.view(torch.int32) & -65536).view(torch.float32)
            pv = torch.einsum("bqhgc,bchd->bqhgd", p_hi, vv)
            pv = pv + torch.einsum("bqhgc,bchd->bqhgd",
                                   (p - p_hi).to(bf).float(), vv)
        else:
            pv = torch.einsum("bqhgc,bchd->bqhgd", p.to(bf).float(), vv)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Sq, Hq, D).to(q.dtype)
