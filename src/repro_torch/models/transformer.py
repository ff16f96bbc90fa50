"""Decoder-only transformer covering the dense, MoE and VLM families
(tinyllama / codeqwen / danube / nemotron / grok / kimi / paligemma).

Layers are stacked: params carry a leading L dim, as the reference's, and
the forward pass loops over the layers in Python where the reference scans.
MoE configs may reserve the first ``first_dense_layers`` layers as plain
dense blocks (kimi-k2 style): those get their own stack, ``layers``, and
the MoE layers theirs, ``moe_layers``, as in the reference; the KV cache
holds both, the dense layers first.  Every attention goes through
``models.attention.attend``: the flash kernel on the card.  A config with
a modality frontend (the VLM) owns its projector, ``proj_in``; a batch's
``prefix_embed`` goes through it and before the tokens, and the whole
sequence attends causally, the prefix too, as in the reference.

``loss_fn`` is the reference's: the forward, the text positions only
after a VLM prefix, the token cross entropy plus the MoE layers' aux loss.
On the card its gradient runs through #6's backward kernels
(``kernels.flash_attention.ops.FlashAttend``).  ``cfg.remat`` checkpoints
each block as the reference's scan body is: "block" recomputes the whole
block in the backward (``torch.utils.checkpoint``), "dots" saves the
matmul outputs and recomputes the rest (PyTorch's selective checkpoint, the
counterpart of ``dots_with_no_batch_dims_saveable``); neither changes the
loss or the gradients.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks, nn
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import attend

Params = Dict[str, Any]

# the layer stacks in the order the layers run: name, MoE or not
STACKS = (("layers", False), ("moe_layers", True))


def _layer(stack: Params, i: int) -> Params:
    return {k: v[i] for k, v in stack.items()}


def _walk(p: Params) -> Iterator[Tuple[Params, bool]]:
    """(layer params, MoE or not) of every layer, in order: the dense
    stack, then the MoE stack; the i-th is the KV cache's layer i."""
    for name, use_moe in STACKS:
        if name in p:
            for i in range(p[name]["attn_norm"].shape[0]):
                yield _layer(p[name], i), use_moe


def _n_moe_layers(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_dense_layers, n_moe_layers) of the stack."""
    if cfg.moe is None:
        return cfg.n_layers, 0
    nd = min(cfg.moe.first_dense_layers, cfg.n_layers)
    return nd, cfg.n_layers - nd


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_layer_stack(generator: torch.Generator, cfg: ModelConfig, n: int,
                     device: torch.device, use_moe: bool = False) -> Params:
    dt = getattr(torch, cfg.param_dtype)
    p = {
        "attn_norm": nn.ones((n, cfg.d_model), dt, device),
        "mlp_norm": nn.ones((n, cfg.d_model), dt, device),
        **blocks.init_attn(generator, cfg, n_stack=n, device=device),
    }
    if use_moe:
        p.update(moe_mod.init_moe(generator, cfg, n_stack=n, device=device))
    else:
        p.update(blocks.init_mlp(generator, cfg, n_stack=n, device=device))
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: Optional[torch.device] = None) -> Params:
    dev = resolve_device(device)
    dt = getattr(torch, cfg.param_dtype)
    nd, nm = _n_moe_layers(cfg)
    p: Params = {**blocks.init_embed(generator, cfg, dev),
                 "final_norm": nn.ones((cfg.d_model,), dt, dev)}
    if nd > 0:
        p["layers"] = init_layer_stack(generator, cfg, nd, dev)
    if nm > 0:
        p["moe_layers"] = init_layer_stack(generator, cfg, nm, dev,
                                           use_moe=True)
    if cfg.frontend is not None:
        p["proj_in"] = nn.dense_init(generator, cfg.frontend.embed_dim,
                                     cfg.d_model, dt, device=dev)
    return p


def _mlp(cfg: ModelConfig, lp: Params, h: torch.Tensor, use_moe: bool,
         **moe_kw) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's MLP: a dense one, or the MoE layer with its aux loss."""
    if use_moe:
        return moe_mod.apply_moe(cfg, lp, h, **moe_kw)
    return blocks.apply_mlp(cfg, lp, h), None


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------


def _block(cfg: ModelConfig, lp: Params, x: torch.Tensor,
           positions: torch.Tensor, use_moe: bool
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    h = nn.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    x = x + blocks.self_attention(cfg, lp, h, positions)
    h = nn.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    y, aux = _mlp(cfg, lp, h, use_moe)
    return x + y, aux


# the products "dots" saves: every matmul's output
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    policy = torch_checkpoint.CheckpointPolicy
    return policy.MUST_SAVE if op in _DOTS else policy.PREFER_RECOMPUTE


def _remat_block(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                 positions: torch.Tensor, use_moe: bool
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``_block`` under ``cfg.remat``'s checkpoint policy; without grad
    there is nothing to save and the block runs as it is."""
    if cfg.remat not in ("none", "block", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}; one of 'none', "
                         "'block', 'dots'")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return _block(cfg, lp, x, positions, use_moe)
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = lambda: (
            torch_checkpoint.create_selective_checkpoint_contexts(_save_dots))
    return torch_checkpoint.checkpoint(_block, cfg, lp, x, positions,
                                       use_moe, use_reentrant=False, **kw)


def embed_inputs(cfg: ModelConfig, p: Params,
                 batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token embeddings and their positions (B, S) int32, with the
    projected modality prefix before the tokens when the config has a
    frontend and the batch a ``prefix_embed`` (the VLM carve-out)."""
    tokens = batch["tokens"]
    x = blocks.embed_tokens(cfg, p, tokens)
    B, S = tokens.shape
    if cfg.frontend is not None and "prefix_embed" in batch:
        pe = nn.dense(batch["prefix_embed"].to(x.dtype), p["proj_in"])
        x = torch.cat([pe, x], dim=1)
        S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    return x, positions


def forward(cfg: ModelConfig, p: Params, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (hidden (B,S,d), aux_loss), the aux
    loss summed over the MoE layers.  The MoE layers dispatch at the
    capacity factor's capacity, as the reference's forward does."""
    x, positions = embed_inputs(cfg, p, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, use_moe in _walk(p):
        x, a = _remat_block(cfg, lp, x, positions, use_moe)
        if a is not None:
            aux = aux + a
    x = nn.rms_norm(x, p["final_norm"], cfg.norm_eps)
    return x, aux


def loss_fn(cfg: ModelConfig, p: Params, batch: Dict[str, torch.Tensor]):
    """(xent + aux, {"xent", "aux"}) over the batch's ``targets`` (and
    ``mask``), the text positions only when a prefix came first."""
    h, aux = forward(cfg, p, batch)
    n_prefix = h.shape[1] - batch["tokens"].shape[1]
    if n_prefix > 0:
        h = h[:, n_prefix:]  # loss only over text positions
    logits = blocks.logits_fn(cfg, p, h)
    loss = blocks.token_xent(logits, batch["targets"], batch.get("mask"))
    return loss + aux, {"xent": loss, "aux": aux}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Optional[torch.device] = None) -> Params:
    return blocks.init_attn_cache(cfg, cfg.n_layers, batch, max_len,
                                  resolve_device(device))


def prefill(cfg: ModelConfig, p: Params, batch: Dict[str, torch.Tensor],
            max_len: Optional[int] = None):
    """Run the prompt, return (last-position logits, populated cache).
    The MoE layers dispatch with ``no_drop=cfg.moe_exact_serving``."""
    x, positions = embed_inputs(cfg, p, batch)
    B, S = x.shape[:2]
    max_len = max_len or S
    Smax = min(max_len, cfg.window_size) if cfg.attention == "swa" else max_len
    L = sum(p[name]["attn_norm"].shape[0] for name, _ in STACKS if name in p)
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
    for i, (lp, use_moe) in enumerate(_walk(p)):
        h = nn.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = blocks.attn_qkv(cfg, lp, h, positions)
        o = attend(q, k, v, positions, positions, causal=True, window=window,
                   chunk=cfg.attn_chunk)
        x = x + nn.dense(o.reshape(B, S, cfg.q_dim), lp["wo"])
        h = nn.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + _mlp(cfg, lp, h, use_moe,
                     no_drop=cfg.moe_exact_serving)[0]
        kc[i][:, slots] = k[:, S - take:]
        vc[i][:, slots] = v[:, S - take:]

    x = nn.rms_norm(x, p["final_norm"], cfg.norm_eps)
    logits = blocks.logits_fn(cfg, p, x[:, -1:])[:, 0]
    return logits, {"k": kc, "v": vc, "kv_pos": kv_pos}


def decode_step(cfg: ModelConfig, p: Params, batch: Dict[str, torch.Tensor],
                cache: Params):
    """One token step.  batch: {"token": (B,1), "pos": (B,)}.  Writes the
    step's K/V rows and positions into ``cache`` in place and returns it.
    The MoE layers dispatch one-hot with
    ``no_drop=cfg.moe_exact_serving``."""
    token, pos = batch["token"], batch["pos"]
    x = blocks.embed_tokens(cfg, p, token)
    Smax = cache["k"].shape[2]
    slot = blocks.cache_slot(cfg, pos, Smax)
    kv_pos = blocks.update_kv_pos(cache["kv_pos"], pos, slot)
    for i, (lp, use_moe) in enumerate(_walk(p)):
        h = nn.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        o, _, _ = blocks.cached_attention_step(
            cfg, lp, h, pos, slot, kv_pos, cache["k"][i], cache["v"][i])
        x = x + o
        h = nn.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + _mlp(cfg, lp, h, use_moe, ep_mode="onehot",
                     no_drop=cfg.moe_exact_serving)[0]
    x = nn.rms_norm(x, p["final_norm"], cfg.norm_eps)
    logits = blocks.logits_fn(cfg, p, x)[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"], "kv_pos": kv_pos}
