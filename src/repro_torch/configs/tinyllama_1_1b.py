"""TinyLlama-1.1B [arXiv:2401.02385].

Llama-2 architecture, small: 22L, d=2048, 32 heads GQA kv=4, d_ff=5632
SwiGLU, vocab=32000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab_size=32000,
    mlp_variant="swiglu",
    attention="full",
    citation="arXiv:2401.02385 (TinyLlama)",
)
