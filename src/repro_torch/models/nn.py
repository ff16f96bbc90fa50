"""Minimal functional NN substrate: params are nested dicts of tensors.

Randomness comes from an explicit ``torch.Generator``.  The reference's
per-path ``fold_in`` of ``jax.random`` keys is not reproduced (torch cannot
reproduce those streams): parity with the reference comes from carrying its
weights, or the initial params its fits started from, over
(``repro_torch.convert``), not from the init.
"""
from __future__ import annotations

from typing import Optional

import torch


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype, scale: Optional[float] = None,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """Truncated-normal fan-in init on [-2, 2] standard deviations, drawn on
    the generator's device and moved to ``device``."""
    std = scale if scale is not None else in_dim**-0.5
    w = torch.empty((in_dim, out_dim), dtype=torch.float32,
                    device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * std).to(device=device, dtype=dtype)
