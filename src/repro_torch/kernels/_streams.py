"""The stream axis of the plain versions: a fleet of S independent problems
is the single problem S times."""
from __future__ import annotations

import functools
from typing import Callable

import torch


def over_streams(ndim: int) -> Callable:
    """Lift a function of one stream, whose first argument has ``ndim``
    dims, to a leading stream axis: with one more dim on the first argument
    (and a leading S on every other tensor argument), it runs on each
    stream and stacks each output.  S = 0 gives empty outputs of the
    per-stream shapes."""

    def lift(fn):
        @functools.wraps(fn)
        def lifted(x, *args, **kw):
            if x.dim() == ndim:
                return fn(x, *args, **kw)
            if x.dim() != ndim + 1:
                raise ValueError(f"{fn.__name__}: the first argument must "
                                 f"have {ndim} dims, or {ndim + 1} with a "
                                 f"stream axis; got {tuple(x.shape)}")
            if len(x) == 0:  # the per-stream shapes, from zero inputs
                one = fn(x.new_zeros(x.shape[1:]),
                         *(a.new_zeros(a.shape[1:]) for a in args), **kw)
                if isinstance(one, tuple):
                    return tuple(o.new_empty((0, *o.shape)) for o in one)
                return one.new_empty((0, *one.shape))
            outs = [fn(x[s], *(a[s] for a in args), **kw)
                    for s in range(len(x))]
            if isinstance(outs[0], tuple):
                return tuple(torch.stack(o) for o in zip(*outs))
            return torch.stack(outs)

        return lifted

    return lift
