"""Zamba2-1.2B [arXiv:2411.15242].

Hybrid: 38 Mamba2 backbone layers (d=2048, ssm_state=64, expand 2) with a
single shared transformer block (32 heads MHA kv=32, d_ff=8192) applied every
6 layers.  SSM state decode -> runs long_500k.
"""
from repro_torch.configs.base import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    mlp_variant="geglu",
    attention="full",  # used by the shared block only
    ssm=SSMConfig(state_dim=64, conv_dim=4, expand=2, head_dim=64),
    hybrid=HybridConfig(attn_every=6),
    citation="arXiv:2411.15242 (Zamba2: Mamba2 + shared attention blocks)",
)
