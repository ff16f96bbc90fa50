"""RWKV-6 (Finch) 3B [arXiv:2404.05892].

Attention-free: 32L, d=2560, data-dependent decay time-mix with head_size 64
(40 heads), channel-mix d_ff=8960, vocab=65536.  O(1)-state decode.
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,  # d_model / head_size
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    mlp_variant="relu",  # rwkv channel-mix uses squared relu internally
    attention="none",
    rwkv=RWKVConfig(head_size=64, decay_lora=64, gate_lora=64),
    citation="arXiv:2404.05892 (RWKV-6 Finch, data-dependent decay)",
)
