"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B].

Qwen1.5 architecture: 32L, d=4096, 32 heads MHA (kv=32), d_ff=13440 SwiGLU,
vocab=92416, QKV projection biases (qwen signature), rope theta 1e6 for long
code context.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab_size=92416,
    mlp_variant="swiglu",
    attention="full",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    citation="hf:Qwen/CodeQwen1.5-7B (qwen1.5 arch)",
)
