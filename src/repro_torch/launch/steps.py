"""Step builders: the functions the launcher runs and the dry run traces,
with their inputs as tensors on the ``meta`` device.

``build_step(cfg, shape)`` returns (fn, kwargs) such that ``fn(**kwargs)``
is the production computation of the input shape on meta tensors: the
train step for train shapes (forward, backward and the AdamW update,
``make_train_step``), the prefill for prefill shapes, one decode step
against a seq_len cache for decode shapes.  The reference attaches
shardings over a mesh (``CACHE_AXES``, ``BATCH_AXES``, ``shard_*``); on one
card there is nothing to shard, and they are not ported.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models.model import get_model, input_specs
from repro_torch.training.optimizer import adamw
from repro_torch.training.train_loop import make_train_step


def param_opt_specs(cfg: ModelConfig):
    """Meta trees (no storage) of the params and AdamW's state, and the
    optimizer: the counterpart of the reference's ``jax.eval_shape`` of
    ``model.init`` and of ``opt.init``.  The generator is not drawn from."""
    params = get_model(cfg).init(torch.Generator(), "meta")
    opt = adamw(1e-4, moment_dtype=cfg.opt_moment_dtype)
    return params, opt.init(params), opt


def build_step(cfg: ModelConfig, shape: InputShape
               ) -> Tuple[Callable[..., Any], Dict[str, Any]]:
    """Returns (fn, kwargs).  fn's signature depends on shape.kind; the
    prefill and the decode step run without grad, as ``Engine``'s do."""
    model = get_model(cfg)
    raw = input_specs(cfg, shape)

    if shape.kind == "train":
        params, opt_state, opt = param_opt_specs(cfg)
        step_fn = make_train_step(model, opt)

        def train(params, opt_state, batch):
            return step_fn(params, opt_state, batch)

        return train, {"params": params, "opt_state": opt_state,
                       "batch": raw["batch"]}

    params, _, _ = param_opt_specs(cfg)
    if shape.kind == "prefill":

        @torch.no_grad()
        def prefill(params, batch):
            return model.prefill(params, batch, shape.seq_len)

        return prefill, {"params": params, "batch": raw["batch"]}

    if shape.kind == "decode":

        @torch.no_grad()
        def decode(params, batch, cache):
            return model.decode_step(params, batch, cache)

        return decode, {"params": params, "batch": raw["batch"],
                        "cache": raw["cache"]}

    raise ValueError(shape.kind)
