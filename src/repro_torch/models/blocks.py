"""Shared transformer building blocks: GQA attention (with KV caches and
sliding windows), cross attention over an encoder's memory, MLP variants,
embeddings and the token cross entropy.

Block params are created per-layer-stacked (leading L dim) or flat, as the
reference's.  The reference's ``shard(...)`` annotations are no-ops on one
device and are dropped.  Unlike the reference's pure functions, the decode
step writes the new K/V row into the cache buffers in place
(``cached_attention_step``) and records its position in ``kv_pos`` in place
(``update_kv_pos``): one (B, Smax, Hkv, D) copy fewer per layer and step.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import nn
from repro_torch.models.attention import attend

Params = Dict[str, Any]


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _window(cfg: ModelConfig) -> int:
    return cfg.window_size if cfg.attention == "swa" else 0


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def init_attn(generator: torch.Generator, cfg: ModelConfig,
              n_stack: Optional[int] = None,
              device: Optional[torch.device] = None) -> Params:
    dt = _dtype(cfg.param_dtype)
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim

    def mk(i, o):
        if n_stack is None:
            return nn.dense_init(generator, i, o, dt, device=device)
        return nn.stacked_dense_init(generator, n_stack, i, o, dt,
                                     device=device)

    p = {"wq": mk(d, qd), "wk": mk(d, kvd), "wv": mk(d, kvd), "wo": mk(qd, d)}
    if cfg.qkv_bias:
        lead = () if n_stack is None else (n_stack,)
        p["bq"] = nn.zeros((*lead, qd), dt, device)
        p["bk"] = nn.zeros((*lead, kvd), dt, device)
        p["bv"] = nn.zeros((*lead, kvd), dt, device)
    return p


def attn_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor,
             positions: torch.Tensor, rope: bool = True
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project + rope.  x: (B,S,d) -> q (B,S,Hq,D), k/v (B,S,Hkv,D)."""
    B, S, _ = x.shape
    D = cfg.resolved_head_dim
    q = nn.dense(x, p["wq"], p.get("bq")).reshape(B, S, cfg.n_heads, D)
    k = nn.dense(x, p["wk"], p.get("bk")).reshape(B, S, cfg.n_kv_heads, D)
    v = nn.dense(x, p["wv"], p.get("bv")).reshape(B, S, cfg.n_kv_heads, D)
    if rope:
        q = nn.apply_rope(q, positions, cfg.rope_theta)
        k = nn.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def self_attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
                   positions: torch.Tensor, *,
                   causal: bool = True) -> torch.Tensor:
    """Full-sequence self attention (train / prefill)."""
    q, k, v = attn_qkv(cfg, p, x, positions)
    p_dtype = (_dtype(cfg.attn_p_dtype)
               if cfg.attn_p_dtype != "float32" else None)

    def att(qq, pos_q):
        return attend(qq, k, v, pos_q, positions, causal=causal,
                      window=_window(cfg), chunk=cfg.attn_chunk,
                      p_dtype=p_dtype)

    qc = cfg.attn_q_chunk
    S = q.shape[1]
    if qc and S > qc and S % qc == 0:
        # block queries too: bounds the live (bq, Sk) score working set
        o = torch.cat([att(q[:, i:i + qc], positions[:, i:i + qc])
                       for i in range(0, S, qc)], dim=1)
    else:
        o = att(q, positions)
    o = o.reshape(*x.shape[:2], cfg.q_dim)
    return nn.dense(o, p["wo"])


def cache_slot(cfg: ModelConfig, pos: torch.Tensor, Smax: int) -> torch.Tensor:
    """Write slot for the current position ((B,) int32)."""
    if cfg.attention == "swa":
        return pos % Smax  # ring buffer
    return torch.clamp(pos, max=Smax - 1)


def _rows(n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device)


def update_kv_pos(kv_pos: torch.Tensor, pos: torch.Tensor,
                  slot: torch.Tensor) -> torch.Tensor:
    """Record the absolute position written into each cache slot (shared
    across layers, so this is done once per decode step).  Writes
    ``kv_pos`` in place and returns it."""
    kv_pos[_rows(kv_pos.shape[0], kv_pos.device), slot.long()] = pos.to(
        kv_pos.dtype)
    return kv_pos


def cached_attention_step(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,  # (B, 1, d)
    pos: torch.Tensor,  # (B,) current absolute position
    slot: torch.Tensor,  # (B,) precomputed write slot
    kv_pos: torch.Tensor,  # (B, Smax) already updated for this step
    k_cache: torch.Tensor,  # (B, Smax, Hkv, D)
    v_cache: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step against a (possibly ring-buffer) KV cache.  The new
    K/V row is written into ``k_cache``/``v_cache`` in place; they are
    returned as the reference returns its updated copies."""
    B = x.shape[0]
    q, k_new, v_new = attn_qkv(cfg, p, x, pos[:, None])
    rows, slot = _rows(B, x.device), slot.long()
    k_cache[rows, slot] = k_new[:, 0].to(k_cache.dtype)
    v_cache[rows, slot] = v_new[:, 0].to(v_cache.dtype)
    o = attend(q, k_cache, v_cache, pos[:, None], kv_pos, causal=True,
               window=_window(cfg), chunk=cfg.attn_chunk)
    o = o.reshape(B, 1, cfg.q_dim)
    return nn.dense(o, p["wo"]), k_cache, v_cache


def cross_attention(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,  # (B, S, d)
    mem_k: torch.Tensor,  # (B, M, Hkv, D) precomputed
    mem_v: torch.Tensor,
    mem_pos: torch.Tensor,  # (B, M)
) -> torch.Tensor:
    """Attention of ``x`` over the encoder memory's K/V: no rope, not
    causal, every query at position 0 (the positions are unused)."""
    B, S, _ = x.shape
    D = cfg.resolved_head_dim
    q = nn.dense(x, p["wq"], p.get("bq")).reshape(B, S, cfg.n_heads, D)
    q_pos = torch.zeros((B, S), dtype=torch.int32, device=x.device)
    o = attend(q, mem_k, mem_v, q_pos, mem_pos, causal=False, window=0,
               chunk=cfg.attn_chunk)
    return nn.dense(o.reshape(B, S, cfg.q_dim), p["wo"])


def project_memory(cfg: ModelConfig, p: Params, mem: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K/V projection of encoder memory for cross attention."""
    B, M, _ = mem.shape
    D = cfg.resolved_head_dim
    k = nn.dense(mem, p["wk"], p.get("bk")).reshape(B, M, cfg.n_kv_heads, D)
    v = nn.dense(mem, p["wv"], p.get("bv")).reshape(B, M, cfg.n_kv_heads, D)
    return k, v


def init_attn_cache(cfg: ModelConfig, n_layers: int, batch: int,
                    max_len: int, device: Optional[torch.device] = None
                    ) -> Params:
    """Stacked (L, B, Smax, Hkv, D) KV cache; kv_pos -1 = unwritten."""
    Smax = min(max_len, cfg.window_size) if cfg.attention == "swa" else max_len
    D = cfg.resolved_head_dim
    dt = _dtype(cfg.dtype)
    shape = (n_layers, batch, Smax, cfg.n_kv_heads, D)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "kv_pos": torch.full((batch, Smax), -1, dtype=torch.int32,
                             device=device),
    }


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(generator: torch.Generator, cfg: ModelConfig,
             n_stack: Optional[int] = None, d_ff: Optional[int] = None,
             device: Optional[torch.device] = None) -> Params:
    dt = _dtype(cfg.param_dtype)
    d, f = cfg.d_model, d_ff or cfg.d_ff

    def mk(i, o):
        if n_stack is None:
            return nn.dense_init(generator, i, o, dt, device=device)
        return nn.stacked_dense_init(generator, n_stack, i, o, dt,
                                     device=device)

    p = {"w_in": mk(d, f), "w_out": mk(f, d)}
    if nn.is_gated(cfg.mlp_variant):
        p["w_gate"] = mk(d, f)
    return p


def apply_mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    h = nn.dense(x, p["w_in"])
    gate = nn.dense(x, p["w_gate"]) if "w_gate" in p else None
    return nn.dense(nn.mlp_act(h, cfg.mlp_variant, gate), p["w_out"])


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def init_embed(generator: torch.Generator, cfg: ModelConfig,
               device: Optional[torch.device] = None) -> Params:
    dt = _dtype(cfg.param_dtype)
    p = {"tok_embed": nn.embed_init(generator, cfg.vocab_size, cfg.d_model,
                                    dt, device)}
    if not cfg.tie_embeddings:
        p["out_head"] = nn.dense_init(generator, cfg.d_model, cfg.vocab_size,
                                      dt, device=device)
    return p


def embed_tokens(cfg: ModelConfig, p: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    x = p["tok_embed"][tokens.long()].to(_dtype(cfg.dtype))
    if cfg.tie_embeddings:
        x = x * (cfg.d_model**0.5)  # gemma-style scaling with tied embeddings
    return x


def token_xent(logits: torch.Tensor, targets: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean masked cross entropy; logits f32 (B,S,V), targets (B,S)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = logz - gold
    mask = torch.ones_like(nll) if mask is None else mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def logits_fn(cfg: ModelConfig, p: Params, h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = torch.matmul(h, p["tok_embed"].to(h.dtype).T)
    else:
        logits = nn.dense(h, p["out_head"])
    logits = logits.float()
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits
