"""Public entry points of flash attention: ``gqa_flash`` and
``flash_attend``.

``flash_attend`` is the positions form the model's ``attend`` rides on the
card: every prefill and decode attention of the dense transformer.
``gqa_flash`` is the counterpart of the reference's ``ops.gqa_flash``: the
same function at arange positions.  A tensor on a CUDA device launches the
kernel (``kernel.flash_attention``) or raises; a tensor on the CPU takes
its plain version (``ref``).  Nothing falls back.

Under grad (grad mode on and q, k or v requiring it) the call goes through
``FlashAttend``, a ``torch.autograd.Function``: its forward is the same
single launch, and it saves q, k, v, the output and the positions; its
backward launches the two backward kernels on the card
(``kernel.flash_attention_backward``) and takes the plain backward
(``ref.flash_attend_bwd_ref``) on the CPU.  Without grad nothing is
saved.  p stays in float32 under grad: ``p_dtype`` bfloat16 has no
backward and raises there.

A tensor on the ``meta`` device (the dry run's trace) takes
``torch.ops.repro_torch.flash_attention`` and, in the backward,
``flash_attention_backward`` (``kernels/_meta.py``): the kernels' output
shapes, and the FLOPs of ``ref.attend_full_ref`` (q Kᵀ and P V over every
(query, key) pair, 4 B Sq Sk Hq D) and of ``ref.flash_attend_bwd_ref`` (the
scores again, dP, dQ, dK and dV: 10 B Sq Sk Hq D).  Causal or windowed, the
plain versions compute every pair and mask after, so the formulas do too.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels._meta import meta_kernel
from repro_torch.kernels.flash_attention import kernel, ref


def _pairs(q, k) -> int:
    """B Sq Sk Hq D: one product over every (query, key) pair."""
    return math.prod(q) * k[1]


@meta_kernel("flash_attention(Tensor q, Tensor k, Tensor v, Tensor q_pos, "
             "Tensor kv_pos) -> Tensor",
             lambda q, k, v, q_pos, kv_pos, out_shape=None:
             4 * _pairs(q, k))
def _flash_meta(q, k, v, q_pos, kv_pos):
    return torch.empty_like(q)


@meta_kernel("flash_attention_backward(Tensor q, Tensor k, Tensor v, "
             "Tensor o, Tensor do, Tensor q_pos, Tensor kv_pos) -> "
             "(Tensor, Tensor, Tensor)",
             lambda q, k, v, o, do, q_pos, kv_pos, out_shape=None:
             10 * _pairs(q, k))
def _flash_backward_meta(q, k, v, o, do, q_pos, kv_pos):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _forward(q, k, v, q_pos, kv_pos, causal, window, scale, p_bf16):
    """The forward on q's device: the kernel on CUDA, the oracle on the
    CPU."""
    if q.device.type == "cuda":
        return kernel.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(),
            q_pos.to(torch.int32).contiguous(),
            kv_pos.to(torch.int32).contiguous(),
            causal=causal, window=window, scale=scale, p_bf16=p_bf16)
    if q.device.type == "cpu":
        return ref.attend_full_ref(q, k, v, q_pos, kv_pos, causal=causal,
                                   window=window, scale=scale,
                                   p_dtype=torch.bfloat16 if p_bf16 else None)
    if q.device.type == "meta":
        return _flash_meta(q, k, v, q_pos, kv_pos)
    raise ValueError(f"flash_attend: unsupported device {q.device}")


class FlashAttend(torch.autograd.Function):
    """Flash attention with its gradient: q, k, v (contiguous on CUDA) and
    int32 positions in, (B,Sq,Hq,D) out."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, causal, window, scale):
        o = _forward(q, k, v, q_pos, kv_pos, causal, window, scale, False)
        ctx.save_for_backward(q, k, v, o, q_pos, kv_pos)
        ctx.attrs = (causal, window, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, q_pos, kv_pos = ctx.saved_tensors
        causal, window, scale = ctx.attrs
        if q.device.type == "cuda":
            grads = kernel.flash_attention_backward(
                q, k, v, o, do.contiguous(), q_pos, kv_pos, causal=causal,
                window=window, scale=scale)
        elif q.device.type == "meta":
            grads = _flash_backward_meta(q, k, v, o, do, q_pos, kv_pos)
        else:
            grads = ref.flash_attend_bwd_ref(q, k, v, o, do, q_pos, kv_pos,
                                             causal=causal, window=window,
                                             scale=scale)
        return (*grads, None, None, None, None, None)


def flash_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                 causal: bool = True, window: int = 0,
                 scale: Optional[float] = None,
                 p_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """q (B,Sq,Hq,D), k and v (B,Sk,Hkv,D), q_pos (B,Sq), kv_pos (B,Sk)
    with -1 on an unwritten slot -> (B,Sq,Hq,D) in ``q.dtype``.
    ``p_dtype`` bfloat16 rounds p and v to bf16 before the P V product (f32
    accumulation); None or float32 keeps p in f32.  Under grad the call
    goes through ``FlashAttend`` (module docstring)."""
    if p_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attend: p_dtype {p_dtype} is not float32 "
                         "or bfloat16")
    p_bf16 = p_dtype == torch.bfloat16
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        return _forward(q, k, v, q_pos, kv_pos, causal, window, scale,
                        p_bf16)
    if p_bf16:
        raise ValueError("flash_attend: p_dtype bfloat16 has no backward; "
                         "under grad p stays float32 (p_dtype None)")
    if q.device.type == "cuda":
        # views after rope and reshape are copied once, here; the copies'
        # gradients flow back to the views
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        q_pos = q_pos.to(torch.int32).contiguous()
        kv_pos = kv_pos.to(torch.int32).contiguous()
    return FlashAttend.apply(q, k, v, q_pos, kv_pos, causal, window, scale)


def gqa_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B,S,Hq,D), k and v (B,S,Hkv,D) -> (B,S,Hq,D), positions 0..S-1.
    The kernel reads KV head hq // (Hq/Hkv) for query head hq; nothing is
    repeated."""
    B, Sq, Sk = q.shape[0], q.shape[1], k.shape[1]
    return flash_attend(q, k, v, ref.arange_positions(B, Sq, q.device),
                        ref.arange_positions(B, Sk, q.device), causal=causal,
                        window=window)
