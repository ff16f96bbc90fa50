"""Minimal functional NN substrate: params are nested dicts of tensors.

Randomness comes from an explicit ``torch.Generator``.  The reference's
per-path ``fold_in`` of ``jax.random`` keys is not reproduced (torch cannot
reproduce those streams): parity with the reference comes from carrying its
weights, or the initial params its fits started from, over
(``repro_torch.convert``), not from the init.  On the ``meta`` device every
initialiser returns an empty tensor of the leaf's shape and dtype and
leaves the generator untouched: the dry run's params (``launch/steps.py``),
the counterpart of the reference's ``jax.eval_shape(model.init, key)``.
Norms and rotary embeddings compute in float32 and cast back to the
input's dtype, as the reference's do.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def is_meta(device: Optional[torch.device]) -> bool:
    """Whether ``device`` names the ``meta`` device (shapes, no values)."""
    return device is not None and torch.device(device).type == "meta"


def _trunc_normal(generator: torch.Generator, shape: Sequence[int]
                  ) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], float32, on the generator's
    device."""
    w = torch.empty(tuple(shape), dtype=torch.float32, device=generator.device)
    return torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                       generator=generator)


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype, scale: Optional[float] = None,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """Truncated-normal fan-in init on [-2, 2] standard deviations, drawn on
    the generator's device and moved to ``device``."""
    if is_meta(device):
        return torch.empty((in_dim, out_dim), dtype=dtype, device=device)
    std = scale if scale is not None else in_dim**-0.5
    w = _trunc_normal(generator, (in_dim, out_dim))
    return (w * std).to(device=device, dtype=dtype)


def stacked_dense_init(generator: torch.Generator, n: int, in_dim: int,
                       out_dim: int, dtype: torch.dtype,
                       scale: Optional[float] = None,
                       device: Optional[torch.device] = None) -> torch.Tensor:
    """(n, in, out) stacked weights, one slice per layer."""
    if is_meta(device):
        return torch.empty((n, in_dim, out_dim), dtype=dtype, device=device)
    std = scale if scale is not None else in_dim**-0.5
    w = _trunc_normal(generator, (n, in_dim, out_dim))
    return (w * std).to(device=device, dtype=dtype)


def normal_init(generator: torch.Generator, shape: Sequence[int],
                scale: float, dtype: torch.dtype,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """Standard normal times ``scale``, drawn in float32 on the generator's
    device and moved to ``device``."""
    if is_meta(device):
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    w = torch.randn(tuple(shape), dtype=torch.float32,
                    device=generator.device, generator=generator)
    return (w * scale).to(device=device, dtype=dtype)


def embed_init(generator: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype,
               device: Optional[torch.device] = None) -> torch.Tensor:
    return normal_init(generator, (vocab, dim), dim**-0.5, dtype, device)


def zeros(shape: Sequence[int], dtype: torch.dtype,
          device: Optional[torch.device] = None) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def ones(shape: Sequence[int], dtype: torch.dtype,
         device: Optional[torch.device] = None) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32, cast back to input dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * gamma.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm in f32 (biased variance), cast back to input dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def mlp_act(h_in: torch.Tensor, variant: str,
            gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Activation for the MLP hidden.  Gated variants consume ``gate``."""
    if variant == "swiglu":
        if gate is None:
            raise ValueError("swiglu needs a gate")
        return F.silu(gate) * h_in
    if variant == "geglu":
        if gate is None:
            raise ValueError("geglu needs a gate")
        return F.gelu(gate, approximate="tanh") * h_in
    if variant == "squared_relu":
        r = F.relu(h_in)
        return r * r
    if variant == "relu":
        return F.relu(h_in)
    if variant == "gelu":
        return F.gelu(h_in, approximate="tanh")
    raise ValueError(f"unknown mlp variant {variant!r}")


def is_gated(variant: str) -> bool:
    return variant in ("swiglu", "geglu")


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies, f32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate the two halves of the head dim (the reference's half-split
    rotation, not the interleaved one).  x: (..., S, H, D); positions:
    broadcastable to (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = rope_freqs(d, theta, x.device)  # (half,)
    ang = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Param trees
# ---------------------------------------------------------------------------


def count_params(params) -> int:
    """Elements over every leaf of a nested dict of tensors."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return int(params.numel())


def tree_cast(params, dtype: torch.dtype):
    """The tree with every floating leaf cast to ``dtype`` (others as
    they are)."""
    if isinstance(params, dict):
        return {k: tree_cast(v, dtype) for k, v in params.items()}
    return params.to(dtype) if params.is_floating_point() else params
