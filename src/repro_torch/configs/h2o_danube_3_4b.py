"""H2O-Danube-3-4B [arXiv:2401.16818 lineage].

Llama+Mistral mix with sliding-window attention: 24L, d=3840, 32 heads GQA
kv=8, d_ff=10240 SwiGLU, vocab=32000.  SWA makes this the one *dense* arch
that runs the long_500k decode shape (window=4096 KV cache).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    mlp_variant="swiglu",
    attention="swa",
    window_size=4096,
    rope_theta=10000.0,
    citation="arXiv:2401.16818 (H2O-Danube); SWA per assignment",
)
