"""The port's optimizers, term for term as the reference's
(``src/repro/training/optimizer.py``): ``adamw`` with clipping by global
norm, moments in float32 (or ``moment_dtype`` bfloat16, the update math
still in float32) whatever the param dtype, bias correction with
``b1 ** step`` taken in float32 tensors, eps after the square root, and
decoupled weight decay added to the step; ``sgd`` with momentum; and the
schedules ``constant`` and ``warmup_cosine``.  ``adamw`` is not
``torch.optim.AdamW``, which puts eps and the weight decay elsewhere.

Params, gradients and moments are nested dicts of tensors.  Leaves are
visited in sorted key order, the order of ``jax.tree_util``, so sums over
leaves (the global norm) add in the reference's order.  Where the reference
returns new arrays, ``update`` writes the new params and moments into the
tensors it was given: the caller hands the trained tree over.  Nothing in an
update reads a device value on the host.

A fleet's tree is stacked, every leaf with a leading stream axis S, and
``update(..., stacked=True)`` is the reference's update under ``jax.vmap``:
each stream clips by its own global norm (``global_norm(..., stacked=True)``,
shape (S,)) and the rest is elementwise.  A ``FleetParamView`` (one stream
of a stacked fit output) passes through the tree functions as the
per-stream tree it stands for.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.stacked import materialize_params

Params = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]


def tree_leaves(tree: Params) -> List[torch.Tensor]:
    """The tensors of a nested dict, in sorted key order."""
    tree = materialize_params(tree)
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable[..., Any], tree: Params, *rest: Params) -> Params:
    """``fn`` applied leaf by leaf over nested dicts of one structure, in
    sorted key order."""
    tree = materialize_params(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_unflatten(like: Params, leaves: List[torch.Tensor]) -> Params:
    """The inverse of ``tree_leaves``: ``leaves`` in the structure of
    ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar on the params' device
    mu: Params
    nu: Params


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], OptState]
    update: Callable[[Params, OptState, Params], Tuple[Params, OptState, Dict]]


def constant(lr: float) -> Schedule:
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def warmup_cosine(lr: float, warmup: int, total: int,
                  final_frac: float = 0.1) -> Schedule:
    """Linear warmup to ``lr`` over ``warmup`` steps, then a cosine decay to
    ``final_frac * lr`` at step ``total``, in float32."""

    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac * lr + (1 - final_frac) * lr * 0.5 * (
            1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)

    return sched


def global_norm(tree: Params, stacked: bool = False) -> torch.Tensor:
    """The norm over every leaf, a scalar; with ``stacked``, each stream's
    over its slices of every leaf, shape (S,)."""
    leaves = tree_leaves(tree)
    if stacked:
        return torch.sqrt(sum(torch.sum(x.float() ** 2,
                                        dim=tuple(range(1, x.dim())))
                              for x in leaves))
    return torch.sqrt(sum(torch.sum(x.float() ** 2) for x in leaves))


def adamw(
    lr: Union[float, Schedule],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    clip_norm: Optional[float] = 1.0,
    moment_dtype: Union[str, torch.dtype] = torch.float32,
) -> Optimizer:
    """``moment_dtype`` bfloat16 halves the optimizer's state; the moments
    are read into float32, updated there and stored back rounded."""
    sched: Schedule = lr if callable(lr) else constant(lr)
    mdt = (getattr(torch, moment_dtype) if isinstance(moment_dtype, str)
           else moment_dtype)

    def init(params: Params) -> OptState:
        zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=mdt,
                                               device=p.device), params)
        step = torch.zeros((), dtype=torch.int32,
                           device=tree_leaves(params)[0].device)
        return OptState(step=step, mu=zeros, nu=tree_map(torch.clone, zeros))

    def update(grads: Params, state: OptState, params: Params,
               stacked: bool = False):
        step = state.step + 1
        stepf = step.float()
        gnorm = global_norm(grads, stacked)
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
        if clip_norm is not None:
            limit = torch.full((), clip_norm, dtype=torch.float32,
                               device=gnorm.device)
            scale = torch.clamp(limit / torch.clamp(gnorm, min=1e-9), max=1.0)
        f32 = dict(dtype=torch.float32, device=gnorm.device)
        bc1 = 1 - torch.full((), b1, **f32) ** stepf
        bc2 = 1 - torch.full((), b2, **f32) ** stepf
        lr_t = sched(step)
        with torch.no_grad():
            for g, m, v, p in zip(*map(tree_leaves,
                                       (grads, state.mu, state.nu, params))):
                # a stream's clip scale over its slice of the leaf
                g = g.float() * (scale.view(-1, *(1,) * (g.dim() - 1))
                                 if stacked else scale)
                m2 = b1 * m.float() + (1 - b1) * g
                v2 = b2 * v.float() + (1 - b2) * g * g
                m.copy_(m2)
                v.copy_(v2)
                delta = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
                if weight_decay > 0:
                    delta = delta + weight_decay * p.float()
                p.copy_(p.float() - lr_t * delta)
        metrics = {"grad_norm": gnorm, "lr": lr_t}
        return params, OptState(step, state.mu, state.nu), metrics

    return Optimizer(init=init, update=update)


def sgd(lr: Union[float, Schedule], momentum: float = 0.0) -> Optimizer:
    """SGD with momentum, float32 momentum whatever the param dtype; no
    clipping.  Its state's ``nu`` is its ``mu``, as the reference's."""
    sched: Schedule = lr if callable(lr) else constant(lr)

    def init(params: Params) -> OptState:
        zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        step = torch.zeros((), dtype=torch.int32,
                           device=tree_leaves(params)[0].device)
        return OptState(step=step, mu=zeros, nu=zeros)

    def update(grads: Params, state: OptState, params: Params,
               stacked: bool = False):
        step = state.step + 1
        lr_t = sched(step)
        with torch.no_grad():
            for g, m, p in zip(*map(tree_leaves,
                                    (grads, state.mu, params))):
                m.copy_(momentum * m + g.float())
                p.copy_(p.float() - lr_t * m)
        metrics = {"grad_norm": global_norm(grads, stacked)}
        return params, OptState(step, state.mu, state.nu), metrics

    return Optimizer(init=init, update=update)
