"""Kimi K2 — trillion-param MoE, 32B active [arXiv:2501.kimi2 per assignment].

61L, d=7168, 64 heads GQA kv=8, vocab=163840; DeepSeek-V3-style fine-grained
MoE: 384 routed experts top-8 with per-expert d_ff=2048, 1 shared expert,
first layer dense (d_ff=18432).  This is the paper-table scale config.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    d_ff=18432,  # dense-layer / shared-path FFN width
    vocab_size=163840,
    mlp_variant="swiglu",
    attention="full",
    moe=MoEConfig(
        n_experts=384,
        top_k=8,
        d_ff_expert=2048,
        capacity_factor=1.0,
        n_shared_experts=1,
        first_dense_layers=1,
    ),
    citation="arXiv:2501.kimi2 (Kimi K2, 1T total / 32B active)",
)
