"""Mamba2 state-space block (used by zamba2's backbone) [arXiv:2405.21060
SSD form; zamba2 per arXiv:2411.15242].

Per head (head dim P, state dim N), scalar decay A per head:

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * (x_t  outer  B_t)
    y_t = h_t @ C_t + D * x_t

with a causal depthwise conv on (x, B, C), softplus dt, and a gated RMSNorm
(silu(z)) before the output projection.

The counterpart of the reference's ``models/ssm.py``, function for
function, with its casts.  Every scan goes through
``kernels.ssm_scan.ops.selective_scan``: the CUDA kernels on the card (a
prefill through the chunked SSD form on the tensor cores, a decode step
through the step-by-step kernel), the per-step plain version on the CPU,
all with the skip ``D`` inside the scan where the reference adds it after
(the same sum, taken in one place).  Under grad the scan goes through
``ops.SelectiveScan``, whose backward is the selective scan's backward
kernel on the card (``kernel.ssm_scan_backward``) and the plain reverse
recurrence on the CPU; the conv, the softplus and the projections around
it are plain autograd.  The reference's switch between its
two XLA forms (``cfg.scan_chunked``) is not ported: nothing sets it for
the hybrid, and the port's hybrid ignores it on every device.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssm_scan import ops, ref
from repro_torch.models import nn

Params = Dict[str, Any]


def dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    xbc_dim = d_inner + 2 * s.state_dim  # x, B, C (single group)
    d_in_proj = 2 * d_inner + 2 * s.state_dim + H  # z, x, B, C, dt
    return d_inner, H, xbc_dim, d_in_proj


def init_block(generator: torch.Generator, cfg: ModelConfig, n: int,
               device: torch.device) -> Params:
    dt_ = getattr(torch, cfg.param_dtype)
    s = cfg.ssm
    d_inner, H, xbc_dim, d_in_proj = dims(cfg)

    def mk(i, o):
        return nn.stacked_dense_init(generator, n, i, o, dt_, device=device)

    conv_w = nn.normal_init(generator, (n, s.conv_dim, xbc_dim),
                            s.conv_dim**-0.5, dt_, device)
    return {
        "in_proj": mk(cfg.d_model, d_in_proj),
        "conv_w": conv_w,
        "conv_b": nn.zeros((n, xbc_dim), dt_, device),
        "A_log": nn.zeros((n, H), torch.float32, device),
        "D": nn.ones((n, H), torch.float32, device),
        "dt_bias": nn.zeros((n, H), torch.float32, device),
        "ssm_norm": nn.ones((n, d_inner), dt_, device),
        "out_proj": mk(d_inner, cfg.d_model),
    }


def _conv_scan(xbc: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise conv, the reference's W-tap elementwise loop.
    xbc: (B,T,C); conv_state: (B,W-1,C) history.  Returns (silu(out), the
    last W-1 inputs)."""
    W = w.shape[0]
    T = xbc.shape[1]
    full = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
    out = full[:, :T] * w[0].to(xbc.dtype)  # the reference's 0 + first tap
    for i in range(1, W):
        out = out + full[:, i:i + T] * w[i].to(xbc.dtype)
    out = out + b.to(xbc.dtype)
    return F.silu(out), full[:, full.shape[1] - (W - 1):]


def apply_block(
    cfg: ModelConfig,
    lp: Params,
    x: torch.Tensor,  # (B, T, d)
    conv_state: torch.Tensor,  # (B, W-1, xbc_dim)
    h_state: Optional[torch.Tensor],  # (B, H, P, N) f32, None: zero
    out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Mamba2 block.  Returns (out (B,T,d), new conv state, new h
    state); the new h state lands in ``out`` when it is given (never under
    grad: ``ops.selective_scan`` refuses it there)."""
    s = cfg.ssm
    B, T, _ = x.shape
    d_inner, H, xbc_dim, _ = dims(cfg)
    P, N = s.head_dim, s.state_dim

    zxbcdt = nn.dense(x, lp["in_proj"])
    z, xbc, dt = torch.split(zxbcdt, [d_inner, xbc_dim, H], dim=-1)
    xbc, conv_state = _conv_scan(xbc, conv_state, lp["conv_w"], lp["conv_b"])
    xs, Bmat, Cmat = torch.split(xbc, [d_inner, N, N], dim=-1)

    dt = F.softplus(dt.float() + lp["dt_bias"])  # (B,T,H)
    A = -torch.exp(lp["A_log"])  # (H,)
    xs_h = xs.reshape(B, T, H, P).float()
    ys, h_state = ops.selective_scan(xs_h, Bmat.float(), Cmat.float(), dt, A,
                                     lp["D"], h_state, out=out)
    y = ys.reshape(B, T, d_inner).to(x.dtype)
    y = y * F.silu(z)
    y = nn.rms_norm(y, lp["ssm_norm"], cfg.norm_eps)
    return nn.dense(y, lp["out_proj"]), conv_state, h_state


def ssd_stepwise(x, b, c, dt, A, h0):
    """Per-timestep selective scan without the skip (the reference's
    baseline path): the plain version with d = 0.
    x: (B,T,H,P) f32; b,c: (B,T,N); dt: (B,T,H); A: (H,); h0: (B,H,P,N).
    Returns (y (B,T,H,P), h_final)."""
    return ref.selective_scan_ref(x, b, c, dt, A, torch.zeros_like(A), h0)


def init_block_cache(cfg: ModelConfig, n: int, batch: int,
                     device: Optional[torch.device] = None) -> Params:
    s = cfg.ssm
    d_inner, H, xbc_dim, _ = dims(cfg)
    return {
        "conv": torch.zeros((n, batch, s.conv_dim - 1, xbc_dim),
                            dtype=getattr(torch, cfg.dtype), device=device),
        "h": torch.zeros((n, batch, H, s.head_dim, s.state_dim),
                         dtype=torch.float32, device=device),
    }
