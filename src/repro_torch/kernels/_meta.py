"""The kernels on the ``meta`` device: shapes, dtypes and FLOPs, no values.

Each kernel's dispatching entry point (``kernels/*/ops.py``) sends a
``meta`` tensor to an operator defined here, ``torch.ops.repro_torch.<name>``,
whose only implementation is its Meta one: empty outputs of the kernel's
shapes and dtypes.  The dry run (``launch/dryrun.py``) traces a whole step
on ``meta`` tensors, so these operators stand where the card launches the
kernels.  Each carries a FLOP formula for
``torch.utils.flop_counter.FlopCounterMode``: what its plain version
(``ref.py``) counts in its matrix products on the same shapes, so a traced
step's count holds the kernels' work as the CPU path's would.  Nothing is
built and no kernel is launched.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils.flop_counter import register_flop_formula

_LIB = torch.library.Library("repro_torch", "FRAGMENT")


def meta_kernel(schema: str, flops: Callable[..., int]):
    """Define ``torch.ops.repro_torch.<name>`` from ``schema`` with the
    decorated function as its Meta implementation and ``flops`` as its
    FLOP formula (called with the tensor arguments' shapes, the other
    arguments as they are and ``out_shape``).  Returns the operator."""

    def define(fake: Callable) -> Callable:
        name = schema.split("(", 1)[0]
        _LIB.define(schema)
        _LIB.impl(name, fake, "Meta")
        op = getattr(torch.ops.repro_torch, name)
        register_flop_formula(op)(flops)
        return op

    return define
