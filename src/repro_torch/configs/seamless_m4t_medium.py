"""SeamlessM4T-medium text decoder + speech encoder backbone [arXiv:2308.11596].

Enc-dec: 12L encoder / 12L decoder, d=1024, 16 heads MHA kv=16, d_ff=4096,
vocab=256206.  Speech frontend (mel + conformer feature extractor) is a stub
per the modality carve-out: ``input_specs`` provides (batch, frames, d)
frame embeddings consumed by the encoder.
"""
from repro_torch.configs.base import EncDecConfig, FrontendStub, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,  # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    mlp_variant="relu",
    attention="full",
    encdec=EncDecConfig(n_encoder_layers=12, encoder_len=1024),
    frontend=FrontendStub(n_prefix_tokens=1024, embed_dim=1024),
    citation="arXiv:2308.11596 (SeamlessM4T, medium)",
)
