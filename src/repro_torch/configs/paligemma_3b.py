"""PaliGemma-3B language backbone [arXiv:2407.07726].

SigLIP vision frontend is a stub per the modality carve-out: ``input_specs``
provides (batch, 256, 1152) patch embeddings; the model owns the projector and
the Gemma-2B-class decoder (18L, d=2048, 8 heads MQA kv=1, head_dim=256,
d_ff=16384 gated-GELU, vocab=257216).
"""
from repro_torch.configs.base import FrontendStub, ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    mlp_variant="geglu",
    attention="full",
    tie_embeddings=True,
    rope_theta=10000.0,
    norm_eps=1e-6,
    frontend=FrontendStub(n_prefix_tokens=256, embed_dim=1152),
    citation="arXiv:2407.07726 (PaliGemma); gemma backbone per model card",
)
