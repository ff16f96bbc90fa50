"""Config dataclasses of the port: the paper's forecaster, the dense and
mixture-of-experts transformers, RWKV6, the Zamba2 hybrid (Mamba2
backbone, shared attention block), the encoder-decoder and the VLM's
modality frontend.

``ModelConfig`` keeps the reference's names for the fields every family
reads, with the reference's defaults.  The transformer fields default to
0 so the LSTM configs construct as before.  The dry run's input shapes
(``InputShape``, ``SHAPES``, ``shape_applicable``) are the reference's;
its ``HardwareModel`` describes one H100 (``H100``), not the reference's
TPU.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class LSTMConfig:
    """The paper's forecaster: LSTM(hidden) -> Dense(dense, relu) -> Dense(1)."""

    hidden: int = 40
    dense: int = 10
    n_features: int = 5
    lag: int = 5  # paper sets time lag n = 5
    out_dim: int = 1


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block config (Switch/DeepSeek style)."""

    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    n_shared_experts: int = 0
    # how many leading layers use a plain dense MLP instead of MoE
    first_dense_layers: int = 0
    router_aux_loss: float = 0.01
    # the dispatch's sub-group length: capacity is counted per group
    dispatch_group: int = 512
    # "auto" | "onehot" | "shard_map": the reference's expert-parallel
    # strategy; on one device both compute the same function
    ep_mode: str = "auto"


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2-style state-space block config.  The reference's
    ``chunk_size`` (the chunk of its SSD form) is not carried: the port
    has no chunked form."""

    state_dim: int = 64
    conv_dim: int = 4
    expand: int = 2
    head_dim: int = 64  # SSM head dim (d_inner / n_heads)


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 (Finch) time-mix config."""

    head_size: int = 64
    decay_lora: int = 64  # rank of the data-dependent decay LoRA
    gate_lora: int = 64


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid: SSM backbone + shared attention block."""

    # a single (shared-weight) transformer block is applied every
    # ``attn_every`` backbone layers, concat-skip from the embedding
    attn_every: int = 6


@dataclass(frozen=True)
class EncDecConfig:
    """Encoder-decoder (seamless-m4t style text decoder + speech encoder)."""

    n_encoder_layers: int = 12
    # the encoder memory's length in the KV cache (the stubbed frontend
    # produces this many frames)
    encoder_len: int = 1024


@dataclass(frozen=True)
class FrontendStub:
    """Modality frontend carve-out: precomputed patch/frame embeddings
    (batch, n_prefix_tokens, embed_dim); the model owns only the
    projector."""

    n_prefix_tokens: int
    embed_dim: int


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0  # 0 -> d_model // n_heads
    mlp_variant: str = "swiglu"
    attention: str = "full"
    window_size: int = 4096  # only used when attention == "swa"
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    logit_softcap: float = 0.0  # grok-style tanh soft capping (0 = off)
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    frontend: Optional[FrontendStub] = None
    lstm: Optional[LSTMConfig] = None
    # training's checkpoint policy of the transformer's blocks: "none",
    # "block" (each block recomputed in the backward) or "dots" (the matmul
    # outputs saved, the rest recomputed)
    remat: str = "none"
    # KV chunk of the CPU path's online-softmax scan; the CUDA kernel tiles
    # on its own and does not read it
    attn_chunk: int = 1024
    attn_p_dtype: str = "float32"  # attention-prob dtype for the PV product
    attn_q_chunk: int = 0  # >0: block queries too (bounds the live score set)
    # the CPU path's RWKV scan: chunked (vs per-step); the CUDA kernel steps
    # through time on its own and reads neither.  The hybrid's Mamba2 scan
    # ignores both: it is per-step on every device
    scan_chunked: bool = False
    scan_chunk: int = 64
    # AdamW's moment dtype: bfloat16 halves the optimizer's state
    opt_moment_dtype: str = "float32"
    # exact (no-drop) MoE serving: decode == prefill == forward, at the
    # worst case's dispatch capacity.  Kept off above 64 experts (the
    # layer falls back to capacity there); single-token decode is exact
    # either way (a token's top-k experts are distinct, so capacity 1
    # suffices)
    moe_exact_serving: bool = True
    citation: str = ""

    # -- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.attention == "none"

    @property
    def supports_long_decode(self) -> bool:
        """Sub-quadratic decode: SSM/linear-attn state, or sliding-window KV."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.attention == "swa"

    @property
    def has_decoder(self) -> bool:
        """Everything here decodes (enc-dec includes a text decoder)."""
        return self.family != "lstm"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- smoke-test reduction ----------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Same family, CPU-runnable: 2 layers, d_model<=256, <=4 experts."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        head_dim = max(32, d_model // n_heads)
        kw = dict(
            n_layers=2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            dtype="float32",
            param_dtype="float32",
            attn_chunk=64,
            window_size=min(self.window_size, 64),
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe,
                n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=min(self.moe.d_ff_expert, 256),
                n_shared_experts=min(self.moe.n_shared_experts, 1),
                first_dense_layers=min(self.moe.first_dense_layers, 1),
            )
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, state_dim=min(self.ssm.state_dim, 16)
            )
        if self.rwkv is not None:
            kw["rwkv"] = dataclasses.replace(
                self.rwkv, head_size=32, decay_lora=16, gate_lora=16
            )
        if self.hybrid is not None:
            kw["hybrid"] = dataclasses.replace(self.hybrid, attn_every=1)
        if self.encdec is not None:
            kw["encdec"] = dataclasses.replace(
                self.encdec, n_encoder_layers=2, encoder_len=16
            )
        if self.frontend is not None:
            kw["frontend"] = dataclasses.replace(
                self.frontend, n_prefix_tokens=8, embed_dim=64
            )
        return self.replace(**kw)


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """Whether (arch, shape) is a live dry-run combo; else reason for the skip."""
    if shape.kind in ("decode", "prefill") and not cfg.has_decoder:
        return False, "architecture has no decode step"
    if shape.name == "long_500k" and not cfg.supports_long_decode:
        return False, (
            "full quadratic attention; no sliding-window/block-sparse variant "
            "configured (see DESIGN.md long_500k skips)"
        )
    return True, ""


# ---------------------------------------------------------------------------
# Hardware model for the roofline analysis
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HardwareModel:
    """A chip's data-sheet rates, the reference's fields.  The default is
    one NVIDIA H100 SXM (H100 80GB HBM3 at its 700 W power limit): dense
    bf16 tensor-core FLOP/s, HBM bytes/s and capacity, shared memory an
    SM in ``vmem_bytes``.  One card has no interconnect to other chips, so
    its collective bandwidth is 0 and the roofline's collective term is 0."""

    name: str = "h100-sxm"
    peak_flops_bf16: float = 989e12  # FLOP/s per chip
    hbm_bw: float = 3.35e12  # B/s per chip
    ici_bw: float = 0.0  # B/s per link: one card, no collectives
    hbm_bytes: float = 80e9  # capacity per chip
    vmem_bytes: float = 228 * 1024  # shared memory per SM


H100 = HardwareModel()
