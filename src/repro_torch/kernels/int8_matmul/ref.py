"""The plain PyTorch version of the int8 dequantizing matmul: the CPU path of
``ops.qmatmul`` and the function the kernel is held to on the card.  With a
leading stream axis (x (S,M,K), q (S,K,N), scale (S,N)) each stream is the
single product, as the kernel computes a fleet's."""
from __future__ import annotations

import torch

from repro_torch.kernels._streams import over_streams


@over_streams(2)
def int8_matmul_ref(x: torch.Tensor, q: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """x (M,K) float, q (K,N) int8, scale (N,) float32 -> (M,N) in
    ``x.dtype``: the float32 product, scaled once per output column."""
    return ((x.float() @ q.float()) * scale).to(x.dtype)
