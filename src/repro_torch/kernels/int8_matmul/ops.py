"""Public entry point of the int8 dequantizing matmul: ``qmatmul``.

``repro_torch.models.lstm._forward_int8`` rides it, the edge's inference on
an int8-synced speed model.  A tensor on a CUDA device launches the kernel
(``kernel.int8_matmul``) or raises; a tensor on the CPU takes its plain
version (``ref``).  Nothing falls back.  A tensor on the ``meta`` device
(the dry run's trace) takes ``torch.ops.repro_torch.int8_matmul``
(``kernels/_meta.py``): the kernel's output shape, and the plain version's
2 M K N FLOPs.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels._meta import meta_kernel
from repro_torch.kernels.int8_matmul import kernel, ref
from repro_torch.serving.quantize import QTensor


@meta_kernel("int8_matmul(Tensor x, Tensor q, Tensor scale) -> Tensor",
             lambda x, q, scale, out_shape=None:
             2 * math.prod(x) * q[-1])
def _int8_meta(x, q, scale):
    return x.new_empty((*x.shape[:-1], q.shape[-1]))


def qmatmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """``x @ dequant(qt)``: ``x`` is (..., K) float32 or bfloat16, ``qt``
    wraps an int8 (K, N) matrix and its (N,) float32 scale; the result is
    (..., N) in ``x.dtype``.  The leading dims are flattened to one M axis
    for the kernel and restored after.  A stacked ``qt`` (q (S,K,N), scale
    (S,N): a fleet's weights) takes x (S, ..., K) and gives (S, ..., N),
    the S products in one launch."""
    lead = x.shape[:-1]
    if qt.q.dim() == 3:
        x2 = x.reshape(x.shape[0], -1, x.shape[-1]).contiguous()
        scale = qt.scale.reshape(qt.q.shape[0], -1)
    else:
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        scale = qt.scale.reshape(-1)
    if x.device.type == "cuda":
        y = kernel.int8_matmul(x2, qt.q, scale)
    elif x.device.type == "cpu":
        y = ref.int8_matmul_ref(x2, qt.q, scale)
    elif x.device.type == "meta":
        y = _int8_meta(x2, qt.q, scale)
    else:
        raise ValueError(f"qmatmul: unsupported device {x.device}")
    return y.reshape(*lead, -1)
