"""Decoder-only transformer, the dense family (tinyllama and the other dense
configs of the reference's zoo).

Layers are stacked: params carry a leading L dim, as the reference's, and
the forward pass loops over the layers in Python where the reference scans.
Every attention goes through ``models.attention.attend``: the flash kernel
on the card.  MoE layers (a ``moe_layers`` stack) and a modality frontend
(``proj_in``, ``prefix_embed``) raise, naming the slice that brings them,
and so does the zoo's training loss.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks, nn
from repro_torch.models.attention import attend

Params = Dict[str, Any]

_LATER = "the rest of the model zoo"


def _check_tree(p: Params) -> None:
    if "moe_layers" in p:
        raise NotImplementedError(f"MoE layers are not ported yet: they come "
                                  f"with {_LATER}")
    if "proj_in" in p:
        raise NotImplementedError(f"modality frontends are not ported yet: "
                                  f"they come with {_LATER}")


def _layer(stack: Params, i: int) -> Params:
    return {k: v[i] for k, v in stack.items()}


def _n_layers(p: Params) -> int:
    return p["layers"]["attn_norm"].shape[0]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_layer_stack(generator: torch.Generator, cfg: ModelConfig, n: int,
                     device: torch.device) -> Params:
    dt = getattr(torch, cfg.param_dtype)
    p = {
        "attn_norm": nn.ones((n, cfg.d_model), dt, device),
        "mlp_norm": nn.ones((n, cfg.d_model), dt, device),
        **blocks.init_attn(generator, cfg, n_stack=n, device=device),
    }
    p.update(blocks.init_mlp(generator, cfg, n_stack=n, device=device))
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: Optional[torch.device] = None) -> Params:
    dev = resolve_device(device)
    dt = getattr(torch, cfg.param_dtype)
    return {**blocks.init_embed(generator, cfg, dev),
            "final_norm": nn.ones((cfg.d_model,), dt, dev),
            "layers": init_layer_stack(generator, cfg, cfg.n_layers, dev)}


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------


def _block(cfg: ModelConfig, lp: Params, x: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    h = nn.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    x = x + blocks.self_attention(cfg, lp, h, positions)
    h = nn.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + blocks.apply_mlp(cfg, lp, h)


def embed_inputs(cfg: ModelConfig, p: Params,
                 batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token embeddings and their positions (B, S) int32."""
    _check_tree(p)
    if "prefix_embed" in batch:
        raise NotImplementedError(f"modality prefixes are not ported yet: "
                                  f"they come with {_LATER}")
    tokens = batch["tokens"]
    x = blocks.embed_tokens(cfg, p, tokens)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    return x, positions


def forward(cfg: ModelConfig, p: Params, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (hidden (B,S,d), aux_loss)."""
    x, positions = embed_inputs(cfg, p, batch)
    for i in range(_n_layers(p)):
        x = _block(cfg, _layer(p["layers"], i), x, positions)
    x = nn.rms_norm(x, p["final_norm"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(cfg: ModelConfig, p: Params, batch: Dict[str, torch.Tensor]):
    raise NotImplementedError(
        f"training the model zoo is not ported yet: it comes with {_LATER}; "
        "the flash kernel has no backward yet")


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Optional[torch.device] = None) -> Params:
    return blocks.init_attn_cache(cfg, cfg.n_layers, batch, max_len,
                                  resolve_device(device))


def prefill(cfg: ModelConfig, p: Params, batch: Dict[str, torch.Tensor],
            max_len: Optional[int] = None):
    """Run the prompt, return (last-position logits, populated cache)."""
    x, positions = embed_inputs(cfg, p, batch)
    B, S = x.shape[:2]
    max_len = max_len or S
    Smax = min(max_len, cfg.window_size) if cfg.attention == "swa" else max_len
    L = _n_layers(p)
    window = cfg.window_size if cfg.attention == "swa" else 0
    dev = x.device

    # place into the fixed cache (keep the last Smax positions for SWA)
    take = min(S, Smax)
    if cfg.attention == "swa":
        # ring layout: position pos lives in slot pos % Smax
        pos_keep = torch.arange(S - take, S, dtype=torch.int32, device=dev)
        slots = (pos_keep % Smax).long()
        kv_pos = torch.full((B, Smax), -1, dtype=torch.int32, device=dev)
        kv_pos[:, slots] = pos_keep
    else:
        slots = torch.arange(take, device=dev)
        kv_pos = torch.cat([
            torch.arange(take, dtype=torch.int32, device=dev).expand(B, take),
            torch.full((B, Smax - take), -1, dtype=torch.int32, device=dev)],
            dim=1)

    shape = (L, B, Smax, cfg.n_kv_heads, cfg.resolved_head_dim)
    kc = torch.zeros(shape, dtype=x.dtype, device=dev)
    vc = torch.zeros(shape, dtype=x.dtype, device=dev)
    for i in range(L):
        lp = _layer(p["layers"], i)
        h = nn.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = blocks.attn_qkv(cfg, lp, h, positions)
        o = attend(q, k, v, positions, positions, causal=True, window=window,
                   chunk=cfg.attn_chunk)
        x = x + nn.dense(o.reshape(B, S, cfg.q_dim), lp["wo"])
        h = nn.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + blocks.apply_mlp(cfg, lp, h)
        kc[i][:, slots] = k[:, S - take:]
        vc[i][:, slots] = v[:, S - take:]

    x = nn.rms_norm(x, p["final_norm"], cfg.norm_eps)
    logits = blocks.logits_fn(cfg, p, x[:, -1:])[:, 0]
    return logits, {"k": kc, "v": vc, "kv_pos": kv_pos}


def decode_step(cfg: ModelConfig, p: Params, batch: Dict[str, torch.Tensor],
                cache: Params):
    """One token step.  batch: {"token": (B,1), "pos": (B,)}.  Writes the
    step's K/V rows and positions into ``cache`` in place and returns it."""
    _check_tree(p)
    token, pos = batch["token"], batch["pos"]
    x = blocks.embed_tokens(cfg, p, token)
    Smax = cache["k"].shape[2]
    slot = blocks.cache_slot(cfg, pos, Smax)
    kv_pos = blocks.update_kv_pos(cache["kv_pos"], pos, slot)
    for i in range(_n_layers(p)):
        lp = _layer(p["layers"], i)
        h = nn.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        o, _, _ = blocks.cached_attention_step(
            cfg, lp, h, pos, slot, kv_pos, cache["k"][i], cache["v"][i])
        x = x + o
        h = nn.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + blocks.apply_mlp(cfg, lp, h)
    x = nn.rms_norm(x, p["final_norm"], cfg.norm_eps)
    logits = blocks.logits_fn(cfg, p, x)[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"], "kv_pos": kv_pos}
