"""Model dispatcher: ``get_model(cfg)`` returns a ``Model`` whose functions
the hybrid learner, the trainers and the serving engine consume.  The port
knows every family of the reference: the LSTM, the dense,
mixture-of-experts and VLM transformers (``dense``, ``moe``, ``vlm``),
RWKV6 (the ``ssm`` family), the Zamba2 hybrid and the encoder-decoder
(``audio``).

    init(generator, device)           -> params
    loss_fn(params, batch)            -> (loss, metrics)
    forward(params, batch)            -> hidden (B, S, d)       (the zoo)
    predict(params, x)                -> (B, out_dim)           (LSTM)
    prefill(params, batch, max_len)   -> (last_logits, cache)   (the zoo)
    decode_step(params, batch, cache) -> (logits, cache)        (the zoo)
    init_cache(batch, max_len, device)-> cache                  (the zoo)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig

Params = Dict[str, Dict[str, torch.Tensor]]
Batch = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[[torch.Generator, Optional[torch.device]], Params]
    loss_fn: Callable[[Params, Batch],
                      Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    predict: Optional[Callable[[Params, torch.Tensor], torch.Tensor]] = None
    forward: Optional[Callable[[Params, Batch], torch.Tensor]] = None
    prefill: Optional[Callable[..., Tuple[torch.Tensor, Params]]] = None
    decode_step: Optional[Callable[[Params, Batch, Params],
                                   Tuple[torch.Tensor, Params]]] = None
    init_cache: Optional[Callable[..., Params]] = None


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family == "lstm":
        from repro_torch.models import lstm as m

        return Model(
            cfg=cfg,
            init=lambda generator, device=None: m.init_params(
                cfg, generator, device),
            loss_fn=lambda p, b: m.loss_fn(cfg, p, b),
            predict=lambda p, x: m.predict(cfg, p, x),
        )
    if cfg.family in ("dense", "moe", "vlm", "ssm", "hybrid", "audio"):
        # ssm is RWKV6, as in the reference; hybrid is Zamba2; audio the
        # encoder-decoder
        if cfg.family in ("dense", "moe", "vlm"):
            from repro_torch.models import transformer as t
        elif cfg.family == "ssm":
            from repro_torch.models import rwkv as t
        elif cfg.family == "hybrid":
            from repro_torch.models import hybrid_arch as t
        else:
            from repro_torch.models import encdec as t

        return Model(
            cfg=cfg,
            init=lambda generator, device=None: t.init_params(
                cfg, generator, device),
            loss_fn=lambda p, b: t.loss_fn(cfg, p, b),
            forward=lambda p, b: t.forward(cfg, p, b)[0],
            prefill=lambda p, b, max_len=None: t.prefill(cfg, p, b, max_len),
            decode_step=lambda p, b, c: t.decode_step(cfg, p, b, c),
            init_cache=lambda bsz, ml, device=None: t.init_cache(
                cfg, bsz, ml, device),
        )
    raise ValueError(f"unknown family {cfg.family!r}; the port has 'lstm', "
                     "'dense', 'moe', 'vlm', 'ssm', 'hybrid' and 'audio'")
