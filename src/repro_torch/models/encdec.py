"""Encoder-decoder backbone (SeamlessM4T-medium text decoder + speech
encoder) [arXiv:2308.11596].

The speech frontend (mel + conv feature extractor) is a stub per the
modality carve-out: the encoder consumes precomputed frame embeddings
(batch, frames, embed_dim), ``batch["prefix_embed"]``.  Layers are
stacked with a leading L dim, as the reference's, and every pass loops
over them in Python where the reference scans.  Every attention goes
through ``models.attention.attend``, the flash kernel on the card: the
encoder's self attention and every cross attention not causal, the
decoder's self attention causal.  The decode step writes the
self-attention K/V into the cache in place and reads the cross K/V
(``ck``, ``cv``, ``mem_pos``) that prefill put there.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks, nn
from repro_torch.models.attention import attend

Params = Dict[str, Any]


def _layer(stack: Params, i: int) -> Params:
    """Layer i of a stack, the nested ``self``/``cross`` dicts too."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stack.items()}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: Optional[torch.device] = None) -> Params:
    dev = resolve_device(device)
    dt = getattr(torch, cfg.param_dtype)
    d = cfg.d_model
    ne = cfg.encdec.n_encoder_layers
    nd = cfg.n_layers
    return {
        **blocks.init_embed(generator, cfg, dev),
        "final_norm": nn.ones((d,), dt, dev),
        "proj_in": nn.dense_init(generator, cfg.frontend.embed_dim, d, dt,
                                 device=dev),
        "enc_norm": {"final_norm": nn.ones((d,), dt, dev)},
        "enc_layers": {
            "attn_norm": nn.ones((ne, d), dt, dev),
            "mlp_norm": nn.ones((ne, d), dt, dev),
            **blocks.init_attn(generator, cfg, n_stack=ne, device=dev),
            **blocks.init_mlp(generator, cfg, n_stack=ne, device=dev),
        },
        "dec_layers": {
            "attn_norm": nn.ones((nd, d), dt, dev),
            "cross_norm": nn.ones((nd, d), dt, dev),
            "mlp_norm": nn.ones((nd, d), dt, dev),
            "self": blocks.init_attn(generator, cfg, n_stack=nd, device=dev),
            "cross": blocks.init_attn(generator, cfg, n_stack=nd,
                                      device=dev),
            **blocks.init_mlp(generator, cfg, n_stack=nd, device=dev),
        },
    }


def _arange(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def _memory_of(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    if "prefix_embed" not in batch:
        raise ValueError(
            "the encoder-decoder needs batch['prefix_embed'], the encoder's "
            "frame embeddings (batch, frames, embed_dim); a text-only batch "
            "(Engine.serve's) has none, and the reference's prefill fails "
            "on it too")
    return batch["prefix_embed"]


def encode(cfg: ModelConfig, p: Params,
           prefix_embed: torch.Tensor) -> torch.Tensor:
    """Frame embeddings -> encoder memory (B, M, d)."""
    x = nn.dense(prefix_embed.to(getattr(torch, cfg.dtype)), p["proj_in"])
    B, M, _ = x.shape
    positions = _arange(B, M, x.device)
    stack = p["enc_layers"]
    for i in range(stack["attn_norm"].shape[0]):
        lp = _layer(stack, i)
        h = nn.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        x = x + blocks.self_attention(cfg, lp, h, positions, causal=False)
        h = nn.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + blocks.apply_mlp(cfg, lp, h)
    return nn.rms_norm(x, p["enc_norm"]["final_norm"], cfg.norm_eps)


def _decoder_seq(cfg: ModelConfig, p: Params, tokens: torch.Tensor,
                 memory: torch.Tensor, collect_kv: bool = False
                 ) -> Tuple[torch.Tensor, Optional[List[Tuple]]]:
    """The decoder over a whole token sequence: (hidden (B,S,d), and with
    ``collect_kv`` each layer's (k, v, memory k, memory v))."""
    B, S = tokens.shape
    x = blocks.embed_tokens(cfg, p, tokens)
    positions = _arange(B, S, x.device)
    mem_pos = _arange(B, memory.shape[1], x.device)
    kv = [] if collect_kv else None
    stack = p["dec_layers"]
    for i in range(stack["attn_norm"].shape[0]):
        lp = _layer(stack, i)
        h = nn.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = blocks.attn_qkv(cfg, lp["self"], h, positions)
        o = attend(q, k, v, positions, positions, causal=True,
                   chunk=cfg.attn_chunk)
        x = x + nn.dense(o.reshape(B, S, cfg.q_dim), lp["self"]["wo"])
        h = nn.rms_norm(x, lp["cross_norm"], cfg.norm_eps)
        mk, mv = blocks.project_memory(cfg, lp["cross"], memory)
        x = x + blocks.cross_attention(cfg, lp["cross"], h, mk, mv, mem_pos)
        h = nn.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + blocks.apply_mlp(cfg, lp, h)
        if collect_kv:
            kv.append((k, v, mk, mv))
    return nn.rms_norm(x, p["final_norm"], cfg.norm_eps), kv


def forward(cfg: ModelConfig, p: Params, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, None]:
    """Full-sequence forward, ``encode`` then ``_decoder_seq``: (the
    decoder's hidden (B, S, d), None)."""
    memory = encode(cfg, p, _memory_of(batch))
    return _decoder_seq(cfg, p, batch["tokens"], memory)


def loss_fn(cfg: ModelConfig, p: Params, batch: Dict[str, torch.Tensor]):
    """Encode the frames, run the decoder over the tokens: (xent,
    {"xent"}) over the batch's ``targets`` (and ``mask``)."""
    memory = encode(cfg, p, _memory_of(batch))
    h, _ = _decoder_seq(cfg, p, batch["tokens"], memory)
    logits = blocks.logits_fn(cfg, p, h)
    loss = blocks.token_xent(logits, batch["targets"], batch.get("mask"))
    return loss, {"xent": loss}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Optional[torch.device] = None) -> Params:
    dev = resolve_device(device)
    c = blocks.init_attn_cache(cfg, cfg.n_layers, batch, max_len, dev)
    M = cfg.encdec.encoder_len
    shape = (cfg.n_layers, batch, M, cfg.n_kv_heads, cfg.resolved_head_dim)
    c["ck"] = torch.zeros(shape, dtype=getattr(torch, cfg.dtype), device=dev)
    c["cv"] = torch.zeros_like(c["ck"])
    c["mem_pos"] = torch.zeros((batch, M), dtype=torch.int32, device=dev)
    return c


def prefill(cfg: ModelConfig, p: Params, batch: Dict[str, torch.Tensor],
            max_len: Optional[int] = None):
    """Encode the frames, run the prompt through the decoder, build all
    caches: (last-position logits, cache)."""
    memory = encode(cfg, p, _memory_of(batch))
    tokens = batch["tokens"]
    B, S = tokens.shape
    Smax = max_len or S
    h, kv = _decoder_seq(cfg, p, tokens, memory, collect_kv=True)
    logits = blocks.logits_fn(cfg, p, h[:, -1:])[:, 0]
    take = min(S, Smax)
    dev = h.device
    shape = (len(kv), B, Smax, cfg.n_kv_heads, cfg.resolved_head_dim)
    kc = torch.zeros(shape, dtype=kv[0][0].dtype, device=dev)
    vc = torch.zeros_like(kc)
    for i, (k, v, _, _) in enumerate(kv):
        kc[i, :, :take] = k[:, S - take:]
        vc[i, :, :take] = v[:, S - take:]
    kv_pos = torch.cat([
        _arange(B, take, dev),
        torch.full((B, Smax - take), -1, dtype=torch.int32, device=dev)],
        dim=1)
    M = memory.shape[1]
    cache = {
        "k": kc, "v": vc, "kv_pos": kv_pos,
        "ck": torch.stack([mk for _, _, mk, _ in kv]),
        "cv": torch.stack([mv for _, _, _, mv in kv]),
        "mem_pos": _arange(B, M, dev).contiguous(),
    }
    return logits, cache


def decode_step(cfg: ModelConfig, p: Params, batch: Dict[str, torch.Tensor],
                cache: Params):
    """One token step.  batch: {"token": (B,1), "pos": (B,)}.  Writes the
    step's self-attention K/V rows and positions into ``cache`` in place
    and returns it; the cross K/V are read as prefill left them."""
    token, pos = batch["token"], batch["pos"]
    x = blocks.embed_tokens(cfg, p, token)
    Smax = cache["k"].shape[2]
    slot = blocks.cache_slot(cfg, pos, Smax)
    kv_pos = blocks.update_kv_pos(cache["kv_pos"], pos, slot)
    stack = p["dec_layers"]
    for i in range(stack["attn_norm"].shape[0]):
        lp = _layer(stack, i)
        h = nn.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        o, _, _ = blocks.cached_attention_step(
            cfg, lp["self"], h, pos, slot, kv_pos, cache["k"][i],
            cache["v"][i])
        x = x + o
        h = nn.rms_norm(x, lp["cross_norm"], cfg.norm_eps)
        x = x + blocks.cross_attention(cfg, lp["cross"], h, cache["ck"][i],
                                       cache["cv"][i], cache["mem_pos"])
        h = nn.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + blocks.apply_mlp(cfg, lp, h)
    x = nn.rms_norm(x, p["final_norm"], cfg.norm_eps)
    logits = blocks.logits_fn(cfg, p, x)[:, 0]
    return logits, dict(cache, kv_pos=kv_pos)
