"""How the port's Hopper kernels round their products' operands and add
their lanes' partial sums, in plain PyTorch: the pieces of the plain
versions of their algorithms (``ssm_scan/ref.py``, ``rwkv6_scan/ref.py``)
that the CPU tests hold to the reference."""
from __future__ import annotations

from typing import Optional

import torch


def tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 ``v`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    the nearest value with 10 mantissa bits, ties away from zero (a half
    unit added to the magnitude's bits, then the low 13 bits cleared)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncated(v: torch.Tensor) -> torch.Tensor:
    """float32 ``v`` with its low 13 mantissa bits cleared: TF32 rounded
    toward zero, as the tensor core reads a float32 operand."""
    return (v.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, rounding: Optional[str]
           ) -> torch.Tensor:
    """a @ b in float32 with the operands rounded as the kernels' products
    round them: None exact, "tf32" each operand once to TF32, "tf32x3"
    each split as hi + lo, hi rounded to TF32 and lo = v - hi read by the
    tensor core in TF32 (rounded toward zero), and the product a_lo b_hi +
    a_hi b_lo + a_hi b_hi (the a_lo b_lo term dropped)."""
    if rounding is None:
        return a @ b
    if rounding == "tf32":
        return tf32(a) @ tf32(b)
    if rounding != "tf32x3":
        raise ValueError(f"operand_rounding must be None, 'tf32' or "
                         f"'tf32x3', got {rounding!r}")
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32_truncated(a - a_hi), tf32_truncated(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def butterfly(pieces):
    """The sum of ``pieces`` (one a lane) as ``__shfl_xor_sync`` adds them
    with offsets n/2, n/4, ..., 1, as the first lane holds it."""
    off = len(pieces) // 2
    while off:
        pieces = [pieces[i] + pieces[i ^ off] for i in range(len(pieces))]
        off //= 2
    return pieces[0]


def decode_lanes(N: int) -> int:
    """The lanes a decode kernel splits a reduction of N over, 4 floats a
    lane: the power of two >= N / 4 (``decode_lanes`` in
    ``ssm_scan/csrc/ssm_decode.cu`` and ``rwkv6_scan/csrc/
    rwkv6_decode.cu``)."""
    lanes = 1
    while 4 * lanes < N:
        lanes *= 2
    return lanes
