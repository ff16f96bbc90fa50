"""Nemotron-4-15B [arXiv:2402.16819].

32L, d=6144, 48 heads GQA kv=8, d_ff=24576 with **squared-ReLU** MLP (no
gate), vocab=256000, untied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    mlp_variant="squared_relu",
    attention="full",
    rope_theta=10000.0,
    citation="arXiv:2402.16819 (Nemotron-4 15B)",
)
