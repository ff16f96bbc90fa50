"""The train-step factory the speed layer's ``CompiledForecaster`` and the
zoo's ``launch/train.py`` run, and the eval step.

``make_train_step(model, opt)`` takes the gradient of ``model.loss_fn`` with
``torch.autograd.grad`` and hands it to the optimizer, which updates the
params in place.  With ``stacked=True`` it steps a fleet's stacked tree: the
gradient of the **sum** of the per-stream losses, which is each stream's own
gradient (a mean would scale every stream by 1/S), and each stream clipped
by its own norm.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.model import Model
from repro_torch.training.optimizer import (
    Optimizer,
    OptState,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

Params = Any
Batch = Dict[str, torch.Tensor]


def make_train_step(model: Model, opt: Optimizer, stacked: bool = False):
    """(params, opt_state, batch) -> (params, opt_state, metrics).  The
    params tree is updated in place and returned; metrics stay on the
    device, each of shape (S,) with ``stacked``."""

    def train_step(params: Params, opt_state: OptState, batch: Batch):
        with torch.enable_grad():
            # detached aliases share the params' storage; they carry the
            # graph so the caller's tensors never require grad
            live = tree_map(lambda p: p.detach().requires_grad_(True), params)
            loss, metrics = model.loss_fn(live, batch)
            # a leaf the loss does not reach gets a zero gradient, as
            # jax.grad gives it (zamba2 with fewer layers than attn_every
            # runs no shared block)
            grads = torch.autograd.grad(loss.sum() if stacked else loss,
                                        tree_leaves(live),
                                        materialize_grads=True)
        params, opt_state, opt_metrics = opt.update(
            tree_unflatten(live, grads), opt_state, params, stacked=stacked)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, {**metrics, **opt_metrics,
                                   "loss": loss.detach()}

    return train_step


def make_eval_step(model: Model):
    """(params, batch) -> metrics: the loss and the loss_fn's metrics, with
    no graph."""

    def eval_step(params: Params, batch: Batch):
        with torch.no_grad():
            loss, metrics = model.loss_fn(params, batch)
        return {**metrics, "loss": loss}

    return eval_step
