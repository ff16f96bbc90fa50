"""Zamba2-style hybrid [arXiv:2411.15242]: Mamba2 backbone with a single
*shared-weight* transformer block applied every ``attn_every`` layers.

As the reference: the shared block input is concat(hidden, original
embedding) projected 2d->d (``shared_down``) and the block then runs at
d_model width (real Zamba2 runs it at 2d with per-application LoRAs,
which the reference omits).

The counterpart of the reference's ``models/hybrid_arch.py``, function for
function.  The backbone is ``n_super`` super-layers of ``attn_every`` Mamba
blocks each, the shared block closing each, plus a remainder tail; where
the reference scans over super-layers and layers, the port loops in
Python over the stacked params.  On the card every Mamba scan is the CUDA
selective-scan kernel (``kernels/ssm_scan``) and every shared-block
attention the flash kernel (through ``attention.attend``).  ``forward``
returns a fresh SSM cache, never writing the one it is given: without grad
the kernel writes each layer's final state straight into its slice of the
new state stack.  ``decode_step`` writes the step's K/V rows and positions
into the given cache in place, as the dense transformer's does.

``loss_fn`` trains it, as the reference's: under grad every Mamba scan's
gradient is the selective scan's backward kernel on the card
(``ops.SelectiveScan``) and every shared-block attention's the flash
backward (``ops.FlashAttend``); ``cfg.remat == "block"`` recomputes each
Mamba block in the backward (``torch.utils.checkpoint``), as the
reference's ``jax.checkpoint`` of its group scan's step.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks, nn, ssm
from repro_torch.models.attention import attend

Params = Dict[str, Any]


def _split(cfg: ModelConfig) -> Tuple[int, int, int]:
    k = cfg.hybrid.attn_every
    n_super = cfg.n_layers // k
    rem = cfg.n_layers - n_super * k
    return k, n_super, rem


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: Optional[torch.device] = None) -> Params:
    dev = resolve_device(device)
    dt = getattr(torch, cfg.param_dtype)
    d = cfg.d_model
    return {
        **blocks.init_embed(generator, cfg, dev),
        "final_norm": nn.ones((d,), dt, dev),
        "mamba": ssm.init_block(generator, cfg, cfg.n_layers, dev),
        "shared": {
            "attn_norm": nn.ones((d,), dt, dev),
            "mlp_norm": nn.ones((d,), dt, dev),
            **blocks.init_attn(generator, cfg, device=dev),
            **blocks.init_mlp(generator, cfg, device=dev),
            "shared_down": nn.dense_init(generator, 2 * d, d, dt, device=dev),
        },
    }


def _mamba_group_scan(cfg: ModelConfig, stack: Params, start: int, n: int,
                      x: torch.Tensor, cache: Params, new: Params
                      ) -> torch.Tensor:
    """Run the ``n`` mamba blocks from layer ``start`` (residual each) from
    ``cache``'s states (``h`` None: zero), writing their new states into
    ``new``.  Under grad each block's new state comes back fresh and is
    copied, and ``cfg.remat == "block"`` checkpoints each block."""
    grad = torch.is_grad_enabled()
    for i in range(start, start + n):
        lp = {name: v[i] for name, v in stack.items()}
        h = None if cache["h"] is None else cache["h"][i]
        args = (cfg, lp, x, cache["conv"][i], h)
        if not grad:
            x, conv, _ = _mamba_step(*args, out=new["h"][i])
        else:
            if cfg.remat == "block":
                x, conv, hs = torch_checkpoint.checkpoint(
                    _mamba_step, *args, use_reentrant=False)
            else:
                x, conv, hs = _mamba_step(*args)
            new["h"][i] = hs
        new["conv"][i] = conv
    return x


def _mamba_step(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                conv: torch.Tensor, h: Optional[torch.Tensor],
                out: Optional[torch.Tensor] = None):
    """One mamba block with its residual: (x + out, new conv, new h); the
    new h lands in ``out`` when it is given."""
    o, conv, h = ssm.apply_block(cfg, lp, x, conv, h, out=out)
    return x + o, conv, h


def _shared_block_seq(cfg: ModelConfig, sp: Params, x, embed0, positions):
    """Full-sequence shared attention block (train/prefill).  Returns
    (x, (k, v)) with k/v for the cache."""
    h_in = torch.cat([x, embed0], dim=-1)
    h = nn.dense(h_in, sp["shared_down"])
    hn = nn.rms_norm(h, sp["attn_norm"], cfg.norm_eps)
    q, k, v = blocks.attn_qkv(cfg, sp, hn, positions)
    o = attend(q, k, v, positions, positions, causal=True,
               chunk=cfg.attn_chunk)
    o = o.reshape(*h.shape[:2], cfg.q_dim)
    h = h + nn.dense(o, sp["wo"])
    hm = nn.rms_norm(h, sp["mlp_norm"], cfg.norm_eps)
    h = h + blocks.apply_mlp(cfg, sp, hm)
    return x + h, (k, v)


def _shared_block_step(cfg: ModelConfig, sp: Params, x, embed0, pos, slot,
                       kv_pos, kc, vc):
    h_in = torch.cat([x, embed0], dim=-1)
    h = nn.dense(h_in, sp["shared_down"])
    hn = nn.rms_norm(h, sp["attn_norm"], cfg.norm_eps)
    o, kc, vc = blocks.cached_attention_step(cfg, sp, hn, pos, slot, kv_pos,
                                             kc, vc)
    h = h + o
    hm = nn.rms_norm(h, sp["mlp_norm"], cfg.norm_eps)
    h = h + blocks.apply_mlp(cfg, sp, hm)
    return x + h, kc, vc


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Optional[torch.device] = None) -> Params:
    """The SSM states of every layer (``conv`` in ``cfg.dtype``, ``h`` in
    float32, batch axis 1) and the shared block's KV cache, one per
    super-layer (batch axis 1; ``kv_pos`` batch axis 0)."""
    dev = resolve_device(device)
    _, n_super, _ = _split(cfg)
    return {**ssm.init_block_cache(cfg, cfg.n_layers, batch, dev),
            **blocks.init_attn_cache(cfg, n_super, batch, max_len, dev)}


def _zero_states(cfg: ModelConfig, batch: int, device: torch.device
                 ) -> Params:
    """The states of a forward without a cache: the conv's zero history,
    and no SSM state, so that each scan starts from zero without reading
    one."""
    conv = ssm.init_block_cache(cfg, cfg.n_layers, batch, "meta")["conv"]
    return {"conv": torch.zeros_like(conv, device=device), "h": None}


def _new_states(cfg: ModelConfig, cache: Params) -> Params:
    conv = cache["conv"]
    h = ssm.init_block_cache(cfg, cfg.n_layers, conv.shape[1], "meta")["h"]
    return {"conv": torch.empty_like(conv),
            "h": torch.empty_like(h, device=conv.device)}


def forward(cfg: ModelConfig, p: Params, batch: Dict[str, torch.Tensor],
            cache: Optional[Params] = None):
    """Full-sequence forward.  Returns (hidden (B,S,d), (conv, h, k, v)):
    the new SSM states and each super-layer's K/V (n_super, B, S, Hkv,
    D).  The cache given is read, never written."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = blocks.embed_tokens(cfg, p, tokens)
    embed0 = x
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    k, n_super, rem = _split(cfg)
    if cache is None:
        cache = _zero_states(cfg, B, x.device)
    new = _new_states(cfg, cache)
    ks, vs = [], []
    for g in range(n_super):
        x = _mamba_group_scan(cfg, p["mamba"], g * k, k, x, cache, new)
        x, (kk, vv) = _shared_block_seq(cfg, p["shared"], x, embed0,
                                        positions)
        ks.append(kk)
        vs.append(vv)
    if rem > 0:
        x = _mamba_group_scan(cfg, p["mamba"], n_super * k, rem, x, cache,
                              new)
    x = nn.rms_norm(x, p["final_norm"], cfg.norm_eps)
    if not ks:  # fewer layers than attn_every: no shared block ran
        empty = x.new_empty((0, B, S, cfg.n_kv_heads, cfg.resolved_head_dim))
        return x, (new["conv"], new["h"], empty, empty)
    return x, (new["conv"], new["h"], torch.stack(ks), torch.stack(vs))


def loss_fn(cfg: ModelConfig, p: Params, batch: Dict[str, torch.Tensor]):
    """(xent, {"xent"}) over the batch's ``targets`` (and ``mask``), the
    reference's ``loss_fn``."""
    h, _ = forward(cfg, p, batch)
    logits = blocks.logits_fn(cfg, p, h)
    loss = blocks.token_xent(logits, batch["targets"], batch.get("mask"))
    return loss, {"xent": loss}


def prefill(cfg: ModelConfig, p: Params, batch: Dict[str, torch.Tensor],
            max_len: Optional[int] = None):
    """Run the prompt, return (last-position logits, a fresh cache): the
    SSM states, and the shared block's K/V of the last min(S, max_len)
    positions placed in a fixed (n_super, B, max_len, Hkv, D) cache with
    ``kv_pos`` -1 in the slots after them."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    Smax = max_len or S
    h, (conv, hst, k_all, v_all) = forward(cfg, p, batch)
    logits = blocks.logits_fn(cfg, p, h[:, -1:])[:, 0]
    take = min(S, Smax)
    shape = (k_all.shape[0], B, Smax, *k_all.shape[3:])
    kc = k_all.new_zeros(shape)
    vc = v_all.new_zeros(shape)
    kc[:, :, :take] = k_all[:, :, S - take:]
    vc[:, :, :take] = v_all[:, :, S - take:]
    dev = tokens.device
    kv_pos = torch.cat([
        torch.arange(take, dtype=torch.int32, device=dev).expand(B, take),
        torch.full((B, Smax - take), -1, dtype=torch.int32, device=dev)],
        dim=1)
    return logits, {"conv": conv, "h": hst, "k": kc, "v": vc,
                    "kv_pos": kv_pos}


def decode_step(cfg: ModelConfig, p: Params, batch: Dict[str, torch.Tensor],
                cache: Params):
    """One token step.  batch: {"token": (B,1), "pos": (B,)}.  Returns
    (logits, cache) with fresh SSM states; the step's K/V rows and
    positions are written into ``cache``'s buffers in place."""
    token, pos = batch["token"], batch["pos"]
    x = blocks.embed_tokens(cfg, p, token)
    embed0 = x
    k, n_super, rem = _split(cfg)
    Smax = cache["k"].shape[2]
    slot = blocks.cache_slot(cfg, pos, Smax)
    kv_pos = blocks.update_kv_pos(cache["kv_pos"], pos, slot)
    new = _new_states(cfg, cache)
    for g in range(n_super):
        x = _mamba_group_scan(cfg, p["mamba"], g * k, k, x, cache, new)
        x, _, _ = _shared_block_step(cfg, p["shared"], x, embed0, pos, slot,
                                     kv_pos, cache["k"][g], cache["v"][g])
    if rem > 0:
        x = _mamba_group_scan(cfg, p["mamba"], n_super * k, rem, x, cache,
                              new)
    x = nn.rms_norm(x, p["final_norm"], cfg.norm_eps)
    logits = blocks.logits_fn(cfg, p, x)[:, 0]
    return logits, {**new, "k": cache["k"], "v": cache["v"],
                    "kv_pos": kv_pos}
