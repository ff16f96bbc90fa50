"""AdamW for the port, term for term as the reference's
(``src/repro/training/optimizer.py: adamw``): clipping by global norm,
float32 moments whatever the param dtype, bias correction with ``b1 ** step``
taken in float32 tensors, eps after the square root, and decoupled weight
decay added to the step.  It is not ``torch.optim.AdamW``, which puts eps
and the weight decay elsewhere.

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
) -> Optimizer:
    sched: Schedule = lr if callable(lr) else constant(lr)

    def init(params: Params) -> OptState:
        zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
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
                m.copy_(b1 * m + (1 - b1) * g)
                v.copy_(b2 * v + (1 - b2) * g * g)
                delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
                if weight_decay > 0:
                    delta = delta + weight_decay * p.float()
                p.copy_(p.float() - lr_t * delta)
        metrics = {"grad_norm": gnorm, "lr": lr_t}
        return params, OptState(step, state.mu, state.nu), metrics

    return Optimizer(init=init, update=update)
