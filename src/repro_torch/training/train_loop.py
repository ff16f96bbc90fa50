"""The train-step factory the speed layer's ``CompiledForecaster`` and the
zoo's ``launch/train.py`` run, the eval step, and ``fit``, the legacy
per-minibatch trainer.

``make_train_step(model, opt)`` takes the gradient of ``model.loss_fn`` with
``torch.autograd.grad`` and hands it to the optimizer, which updates the
params in place.  With ``stacked=True`` it steps a fleet's stacked tree: the
gradient of the **sum** of the per-stream losses, which is each stream's own
gradient (a mean would scale every stream by 1/S), and each stream clipped
by its own norm.

``fit`` is the reference's executed per-call trainer (``lstm_forecaster(
compiled=False)``): one train step a minibatch, every example every epoch,
the last minibatch of an epoch ragged when ``n % batch_size != 0`` (250
examples in batches of 64: 64, 64, 64, 58), nothing padded.  The reference
draws its init and each epoch's permutation from a ``jax.random`` key, which
torch cannot reproduce; so the draws are split from the loop.  ``fit`` and
``batch_iterator`` draw from an integer ``key``
(``torch.Generator().manual_seed(key)``: the init, and one
``torch.randperm(n)`` an epoch), and ``fit_loop`` trains from draws it is
handed, the reference's among them.  The window goes to the device once and
each minibatch is gathered there.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.model import Model
from repro_torch.training.optimizer import (
    Optimizer,
    OptState,
    adamw,
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


@dataclass
class FitResult:
    params: Params
    opt_state: OptState
    history: list
    wall_time_s: float
    steps: int


def epoch_permutations(n: int, epochs: int, key: int,
                       shuffle: bool = True) -> torch.Tensor:
    """The epochs' example orders, (epochs, n) int64 on the CPU: one
    ``torch.randperm(n)`` an epoch from ``torch.Generator().manual_seed(
    key)``, or ``arange(n)`` each epoch without ``shuffle``."""
    if not shuffle:
        return torch.arange(n).repeat(epochs, 1)
    gen = torch.Generator().manual_seed(int(key))
    perms = [torch.randperm(n, generator=gen) for _ in range(epochs)]
    return (torch.stack(perms) if perms
            else torch.empty((0, n), dtype=torch.long))


def minibatches(data: Dict[str, np.ndarray], perms: torch.Tensor,
                batch_size: int, device: torch.device) -> Iterable[Batch]:
    """The minibatches of the epochs in ``perms`` ((epochs, n) indices into
    the examples): each epoch's order cut into ``batch_size`` pieces, the
    last one ragged.  The arrays go to ``device`` once; each minibatch is
    gathered there."""
    arrays = {k: torch.as_tensor(np.asarray(v), device=device)
              for k, v in data.items()}
    perms = perms.to(device=device, dtype=torch.long)
    n = perms.shape[1]
    for perm in perms:
        for i in range(0, n, batch_size):
            idx = perm[i : i + batch_size]
            yield {k: v[idx] for k, v in arrays.items()}


def batch_iterator(data: Dict[str, np.ndarray], batch_size: int, epochs: int,
                   key: int, shuffle: bool = True,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> Iterable[Batch]:
    """Epoch-based minibatcher over array dicts (leading dim = examples) on
    ``device`` (the current CUDA device by default).

    Every example is yielded every epoch: the final batch is ragged when
    ``n % batch_size != 0`` (the speed layer's freshest records live in
    that tail).  The compiled hot path (``training.compiled``) pads to shape
    buckets instead."""
    n = len(next(iter(data.values())))
    yield from minibatches(data, epoch_permutations(n, epochs, key, shuffle),
                           batch_size, resolve_device(device))


def fit_loop(model: Model, data: Dict[str, np.ndarray], init_params: Params,
             perms: torch.Tensor, *, batch_size: int, lr: float = 1e-3,
             opt: Optional[Optimizer] = None, log_every: int = 0,
             device: Optional[Union[str, torch.device]] = None) -> FitResult:
    """The reference's ``fit`` loop from given draws: a private copy of
    ``init_params`` on ``device`` trained one step a minibatch over the
    epochs of ``perms`` ((epochs, n) example indices).  ``history`` holds
    every ``log_every``-th step's metrics, else the last loss.  The wall
    covers the loop, the window's copy to the device and the device's sync
    at its end."""
    dev = resolve_device(device)
    params = tree_map(lambda p: p.detach().to(dev, copy=True), init_params)
    opt = opt or adamw(lr)
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt)

    history = []
    t0 = time.perf_counter()
    steps = 0
    for batch in minibatches(data, perms, batch_size, dev):
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        steps += 1
        if log_every and steps % log_every == 0:
            history.append({k: float(v) for k, v in metrics.items()})
    # the steps run asynchronously: wait for them before reading the clock
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    if not history:
        history.append({"loss": float(metrics["loss"])} if steps else {})
    return FitResult(params=params, opt_state=opt_state, history=history,
                     wall_time_s=wall, steps=steps)


def fit(
    model: Model,
    data: Dict[str, np.ndarray],
    *,
    epochs: int,
    batch_size: int,
    lr: float = 1e-3,
    params: Optional[Params] = None,
    opt: Optional[Optimizer] = None,
    key: Optional[int] = None,
    log_every: int = 0,
    device: Optional[Union[str, torch.device]] = None,
) -> FitResult:
    """Executed training loop (paper batch/speed training) on ``device``
    (the current CUDA device by default): init params drawn from ``key``
    unless ``params`` are given (the caller's tree is not updated), one
    train step a minibatch of ``batch_iterator(..., key)``, Keras-style."""
    dev = resolve_device(device)
    key = 0 if key is None else int(key)
    if params is None:
        params = model.init(torch.Generator().manual_seed(key), dev)
    n = len(next(iter(data.values())))
    return fit_loop(model, data, params, epoch_permutations(n, epochs, key),
                    batch_size=batch_size, lr=lr, opt=opt,
                    log_every=log_every, device=dev)
