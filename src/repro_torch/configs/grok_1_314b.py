"""Grok-1 314B MoE [hf:xai-org/grok-1].

64L, d=6144, 48 heads GQA kv=8, vocab=131072; MoE with 8 experts top-2,
expert d_ff=32768 gated-GELU; tanh logit soft-capping (grok signature 30.0).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    mlp_variant="geglu",
    attention="full",
    logit_softcap=30.0,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32768, capacity_factor=1.25),
    citation="hf:xai-org/grok-1",
)
