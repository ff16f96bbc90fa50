"""The train-step factory the speed layer's ``CompiledForecaster`` runs.

``make_train_step(model, opt)`` takes the gradient of ``model.loss_fn`` with
``torch.autograd.grad`` and hands it to the optimizer, which updates the
params in place.
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


def make_train_step(model: Model, opt: Optimizer):
    """(params, opt_state, batch) -> (params, opt_state, metrics).  The
    params tree is updated in place and returned; metrics stay on the
    device."""

    def train_step(params: Params, opt_state: OptState, batch: Batch):
        with torch.enable_grad():
            # detached aliases share the params' storage; they carry the
            # graph so the caller's tensors never require grad
            live = tree_map(lambda p: p.detach().requires_grad_(True), params)
            loss, metrics = model.loss_fn(live, batch)
            grads = torch.autograd.grad(loss, tree_leaves(live))
        params, opt_state, opt_metrics = opt.update(
            tree_unflatten(live, grads), opt_state, params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, {**metrics, **opt_metrics,
                                   "loss": loss.detach()}

    return train_step
