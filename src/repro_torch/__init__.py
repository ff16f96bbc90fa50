"""PyTorch and CUDA port of the ``repro`` package, for one NVIDIA H100.

The subpackages mirror ``repro``'s layout and names, so each module's
counterpart is found at the same path.  The port imports ``torch``, numpy and
scipy, never ``jax`` and nothing of ``repro``.  Its entry points run on the
card unless the caller passes ``device="cpu"``; see :func:`resolve_device`.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    current CUDA device.  With no device named and no CUDA present this
    raises rather than carrying on quietly on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
