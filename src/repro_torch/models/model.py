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

``input_specs(cfg, shape)`` gives the step's inputs of an ``InputShape`` as
tensors on the ``meta`` device: shapes and dtypes, no storage.  It is the
counterpart of the reference's ``ShapeDtypeStruct`` specs, which the dry
run (``launch/steps.py``) traces the step on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig

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


# ---------------------------------------------------------------------------
# meta input specs (the dry-run pattern)
# ---------------------------------------------------------------------------


def _spec(shape, dtype) -> torch.Tensor:
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Meta stand-ins for the step function of this input shape, with the
    reference's keys, shapes and dtypes.

    train   -> kwargs of loss/train step: {"batch": {...}}
    prefill -> kwargs of prefill step:    {"batch": {...}}
    decode  -> kwargs of decode step:     {"batch": {...}, "cache": {...}}
    """
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "lstm":
        c = cfg.lstm
        return {"batch": {"x": _spec((B, c.lag, c.n_features), cfg.dtype),
                          "y": _spec((B, c.out_dim), cfg.dtype)}}

    def token_batch(seq_len):
        b: Dict[str, Any] = {"tokens": _spec((B, seq_len), torch.int32)}
        if cfg.frontend is not None:
            fe = cfg.frontend
            b["prefix_embed"] = _spec((B, fe.n_prefix_tokens, fe.embed_dim),
                                      cfg.dtype)
        return b

    # the VLM prefix counts toward the sequence budget
    text_len = S - (cfg.frontend.n_prefix_tokens
                    if cfg.family == "vlm" and cfg.frontend else 0)
    if shape.kind == "train":
        b = token_batch(text_len)
        b["targets"] = _spec((B, text_len), torch.int32)
        return {"batch": b}
    if shape.kind == "prefill":
        return {"batch": token_batch(text_len)}
    if shape.kind == "decode":
        # the encoder-decoder's cross K/V and memory positions live in the
        # cache already
        return {"batch": {"token": _spec((B, 1), torch.int32),
                          "pos": _spec((B,), torch.int32)},
                "cache": get_model(cfg).init_cache(B, S, device="meta")}
    raise ValueError(shape.kind)
