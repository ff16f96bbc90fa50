"""RWKV-6 "Finch" [arXiv:2404.05892], the ``ssm`` family: attention-free
time-mix with data-dependent decay.

Per head (head_size N): with receptance r_t, key k_t, value v_t, decay
w_t in (0,1)^N (data-dependent via a LoRA on the token-shifted input) and
bonus u:

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

Token-shift mixing uses the RWKV6 data-dependent lerp (ddlerp): a shared
first-stage mix plus a 5-way LoRA producing per-projection mix coefficients
for (r, k, v, g, w).  RMSNorm instead of LayerNorm (gamma-only), and the
time-mix output's group norm approximated by RMS, as the reference does.

The counterpart of the reference's ``models/rwkv.py``, function for
function, with its casts.  Layers are stacked (a leading L dim) and looped
over in Python where the reference scans.  Every WKV recurrence goes
through ``kernels.rwkv6_scan.ops.wkv``: the CUDA kernel on the card, the
per-step plain version on the CPU, except that the CPU takes the
reference's chunked form when ``cfg.scan_chunked`` says so.  ``forward``
returns a fresh cache tree, as the reference's does: without grad the
kernel writes each layer's final state straight into its slice of the new
state stack.

``loss_fn`` trains it, as the reference's: under grad every recurrence
goes through ``ops.WKV``, whose backward is the WKV backward kernel on the
card (``kernel.rwkv6_scan_backward``) and the plain reverse recurrence on
the CPU; ``cfg.remat == "block"`` recomputes each layer in the backward
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` of its
scan step.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as torch_checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6_scan import ops, ref
from repro_torch.models import blocks, nn

Params = Dict[str, Any]

N_MIX = 5  # r, k, v, g, w
MIX_LORA = 32  # rank of the ddlerp LoRA


def _heads(cfg: ModelConfig) -> Tuple[int, int]:
    """(H, N): heads and head size of the time-mix."""
    N = cfg.rwkv.head_size
    return cfg.d_model // N, N


def _layer(stack: Params, i: int) -> Params:
    return {k: v[i] for k, v in stack.items()}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_layer_stack(generator: torch.Generator, cfg: ModelConfig, n: int,
                     device: torch.device) -> Params:
    dt = getattr(torch, cfg.param_dtype)
    d = cfg.d_model
    r = cfg.rwkv.decay_lora
    H, N = _heads(cfg)

    def mk(i, o):
        return nn.stacked_dense_init(generator, n, i, o, dt, device=device)

    mix_lora_b = nn.normal_init(generator, (n, N_MIX, MIX_LORA, d), 0.01, dt,
                                device)
    return {
        "attn_norm": nn.ones((n, d), dt, device),
        "mlp_norm": nn.ones((n, d), dt, device),
        # time-mix projections
        "w_r": mk(d, d),
        "w_k": mk(d, d),
        "w_v": mk(d, d),
        "w_g": mk(d, d),
        "w_o": mk(d, d),
        # ddlerp token-shift mixing
        "mix_base": nn.zeros((n, N_MIX + 1, d), dt, device),
        "mix_lora_a": mk(d, N_MIX * MIX_LORA),
        "mix_lora_b": mix_lora_b,
        # data-dependent decay
        "decay_base": nn.zeros((n, d), dt, device),
        "decay_lora_a": mk(d, r),
        "decay_lora_b": mk(r, d),
        "bonus": nn.zeros((n, H, N), dt, device),
        "ln_x": nn.ones((n, d), dt, device),
        # channel-mix
        "ck_mix": nn.zeros((n, 2, d), dt, device),
        "ck_in": mk(d, cfg.d_ff),
        "ck_out": mk(cfg.d_ff, d),
        "ck_rec": mk(d, d),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: Optional[torch.device] = None) -> Params:
    dev = resolve_device(device)
    dt = getattr(torch, cfg.param_dtype)
    return {**blocks.init_embed(generator, cfg, dev),
            "final_norm": nn.ones((cfg.d_model,), dt, dev),
            "layers": init_layer_stack(generator, cfg, cfg.n_layers, dev)}


# ---------------------------------------------------------------------------
# time mix
# ---------------------------------------------------------------------------


def _ddlerp(lp: Params, x: torch.Tensor, x_prev: torch.Tensor):
    """RWKV6 data-dependent token-shift mix -> [xr, xk, xv, xg, xw]."""
    xx = x_prev - x
    mu = lp["mix_base"].to(x.dtype)  # (6, d)
    xxx = x + xx * mu[0]
    lora = torch.tanh(nn.dense(xxx, lp["mix_lora_a"]))  # (B,T,5*32)
    B, T = x.shape[:2]
    lora = lora.reshape(B, T, N_MIX, MIX_LORA)
    mix = mu[1:] + torch.einsum("btnr,nrd->btnd", lora,
                                lp["mix_lora_b"].to(x.dtype))
    return [x + xx * mix[:, :, i] for i in range(N_MIX)]


def wkv_stepwise(r, k, v, w, u, state):
    """Per-timestep WKV scan (the reference's baseline path): the kernel's
    plain version, which ``ops.wkv`` takes on the CPU.  r/k/v/w: (B,T,H,N)
    f32; u: (H,N); state: (B,H,N,N) f32.  Returns (y (B,T,H,N), state)."""
    return ref.wkv_ref(r, k, v, w, u, state)


def wkv_chunked(r, k, v, w, u, state, chunk: int = 64):
    """Chunked-parallel WKV, the reference's perf path on the CPU.

    Mathematically identical to ``wkv_stepwise``: within a chunk of C steps
    the intra-chunk interaction is one masked (C, C) matrix per head built
    from pairwise decay products exp(L_{t-1} - L_s) (computed in log space,
    always <= 1 so no overflow), and the cross-chunk carry is a single
    matmul-style state update.
    """
    B, T, H, N = r.shape
    C = min(chunk, T)
    pad = (-T) % C
    if pad:
        r, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v))
        # padded steps decay by 1: the state passes through them unchanged
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    nC = (T + pad) // C
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                      diagonal=-1)[None, :, :, None]
    ys = []
    for c in range(nC):
        rc, kc, vc, wc = (a[:, c * C:(c + 1) * C] for a in (r, k, v, w))
        # the floor is a normal float32, as the reference's
        lw = torch.log(torch.clamp(wc, min=1e-30))  # (B,C,H,N), <= 0
        L = torch.cumsum(lw, dim=1)  # inclusive
        L_excl = L - lw  # exclusive: L_{t-1}
        # inter: state contribution, decayed on the key channel
        y_inter = torch.einsum("bthn,bhnm->bthm", rc * torch.exp(L_excl),
                               state)
        # intra: A[t,s] = sum_n r_t k_s exp(L_{t-1,n} - L_{s,n}) for s < t
        D = torch.clamp(L_excl[:, :, None] - L[:, None, :], max=0.0)
        A = torch.einsum("bthn,bshn,btshn->btsh", rc, kc, torch.exp(D))
        A = torch.where(mask, A, 0.0)
        y_intra = torch.einsum("btsh,bshn->bthn", A, vc)
        # current-step bonus term
        y_diag = torch.einsum("bthn,hn,bthn->bth", rc, u, kc)[..., None] * vc
        # state update: S' = diag(exp(L_C)) S + sum_s (k_s exp(L_C - L_s)) v_s^T
        k_dec = kc * torch.exp(L[:, -1][:, None] - L)  # (B,C,H,N), <= 1
        state = torch.exp(L[:, -1])[..., None] * state + torch.einsum(
            "bshn,bshm->bhnm", k_dec, vc)
        ys.append(y_inter + y_intra + y_diag)
    return torch.cat(ys, dim=1)[:, :T], state


def time_mix_scan(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                  x_last: torch.Tensor, state: torch.Tensor,
                  out: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sequence form.  x: (B,T,d); x_last: (B,d) shift state;
    state: (B,H,N,N) f32.  Returns (out, new_x_last, new_state); the new
    state lands in ``out`` when it is given (never under grad: ``ops.wkv``
    refuses it there)."""
    B, T, d = x.shape
    H, N = _heads(cfg)
    x_prev = torch.cat([x_last[:, None], x[:, :-1]], dim=1)
    xr, xk, xv, xg, xw = _ddlerp(lp, x, x_prev)

    r = nn.dense(xr, lp["w_r"]).reshape(B, T, H, N)
    k = nn.dense(xk, lp["w_k"]).reshape(B, T, H, N)
    v = nn.dense(xv, lp["w_v"]).reshape(B, T, H, N)
    g = F.silu(nn.dense(xg, lp["w_g"]))
    dw = torch.tanh(nn.dense(xw, lp["decay_lora_a"]))
    dw = nn.dense(dw, lp["decay_lora_b"]) + lp["decay_base"].to(x.dtype)
    w = torch.exp(-torch.exp(dw.float())).reshape(B, T, H, N)
    u = lp["bonus"].float()  # (H, N)

    rf, kf, vf = (a.float() for a in (r, k, v))
    if x.device.type == "cpu" and cfg.scan_chunked and T > 1:
        ys, state = wkv_chunked(rf, kf, vf, w, u, state,
                                chunk=cfg.scan_chunk)
        if out is not None:
            state = out.copy_(state)
    else:
        ys, state = ops.wkv(rf, kf, vf, w, u, state, out=out)
    y = ys.reshape(B, T, d).to(x.dtype)
    # per-head RMS (group-norm stand-in), then gate and output proj
    y = nn.rms_norm(y, lp["ln_x"], cfg.norm_eps)
    return nn.dense(y * g, lp["w_o"]), x[:, -1], state


# ---------------------------------------------------------------------------
# channel mix
# ---------------------------------------------------------------------------


def channel_mix(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                x_last: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x_prev = torch.cat([x_last[:, None], x[:, :-1]], dim=1)
    mu = lp["ck_mix"].to(x.dtype)  # (2, d)
    xk = x + (x_prev - x) * mu[0]
    xr = x + (x_prev - x) * mu[1]
    kk = F.relu(nn.dense(xk, lp["ck_in"]))
    vv = nn.dense(kk * kk, lp["ck_out"])
    rr = torch.sigmoid(nn.dense(xr, lp["ck_rec"]))
    return rr * vv, x[:, -1]


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


def _block(cfg: ModelConfig, lp: Params, x: torch.Tensor,
           shift_tm: torch.Tensor, shift_cm: torch.Tensor,
           state: torch.Tensor, out: Optional[torch.Tensor] = None):
    """One layer: time-mix then channel-mix, each residual.  Returns (x,
    new shift_tm, new shift_cm, new state); the new state lands in ``out``
    when it is given."""
    h = nn.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    o, shift_tm, state = time_mix_scan(cfg, lp, h, shift_tm, state, out=out)
    x = x + o
    h = nn.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    o, shift_cm = channel_mix(cfg, lp, h, shift_cm)
    return x + o, shift_tm, shift_cm, state


def forward(cfg: ModelConfig, p: Params, batch: Dict[str, torch.Tensor],
            cache: Optional[Params] = None):
    """Full-sequence forward; returns (hidden, aux=0, new_cache).  The
    cache given is read, never written.  Under grad each layer's new state
    comes back fresh and is copied into the new cache, and
    ``cfg.remat == "block"`` checkpoints each layer."""
    x = blocks.embed_tokens(cfg, p, batch["tokens"])
    B = x.shape[0]
    if cache is None:
        cache = init_cache(cfg, B, 0, x.device)
    new = {name: torch.empty_like(t) for name, t in cache.items()}
    grad = torch.is_grad_enabled()
    for i in range(p["layers"]["attn_norm"].shape[0]):
        args = (cfg, _layer(p["layers"], i), x, cache["shift_tm"][i],
                cache["shift_cm"][i], cache["state"][i])
        if not grad:
            x, shift_tm, shift_cm, _ = _block(*args, out=new["state"][i])
        else:
            if cfg.remat == "block":
                x, shift_tm, shift_cm, state = torch_checkpoint.checkpoint(
                    _block, *args, use_reentrant=False)
            else:
                x, shift_tm, shift_cm, state = _block(*args)
            new["state"][i] = state
        new["shift_tm"][i] = shift_tm
        new["shift_cm"][i] = shift_cm
    x = nn.rms_norm(x, p["final_norm"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device), new


def loss_fn(cfg: ModelConfig, p: Params, batch: Dict[str, torch.Tensor]):
    """(xent, {"xent", "aux"}) over the batch's ``targets`` (and ``mask``),
    the reference's ``loss_fn``; aux is 0."""
    h, aux, _ = forward(cfg, p, batch)
    logits = blocks.logits_fn(cfg, p, h)
    loss = blocks.token_xent(logits, batch["targets"], batch.get("mask"))
    return loss, {"xent": loss, "aux": aux}


def init_cache(cfg: ModelConfig, batch: int, max_len: int = 0,
               device: Optional[torch.device] = None) -> Params:
    """RWKV decode state is O(1) in sequence length: the (N, N) WKV state
    of every layer and head in float32, and the two token shifts in
    ``cfg.dtype``.  ``max_len`` is not read."""
    dev = resolve_device(device)
    H, N = _heads(cfg)
    L, d = cfg.n_layers, cfg.d_model
    dt = getattr(torch, cfg.dtype)
    return {
        "state": torch.zeros((L, batch, H, N, N), dtype=torch.float32,
                             device=dev),
        "shift_tm": torch.zeros((L, batch, d), dtype=dt, device=dev),
        "shift_cm": torch.zeros((L, batch, d), dtype=dt, device=dev),
    }


def prefill(cfg: ModelConfig, p: Params, batch: Dict[str, torch.Tensor],
            max_len: Optional[int] = None):
    """Run the prompt, return (last-position logits, a fresh cache)."""
    h, _, cache = forward(cfg, p, batch)
    logits = blocks.logits_fn(cfg, p, h[:, -1:])[:, 0]
    return logits, cache


def decode_step(cfg: ModelConfig, p: Params, batch: Dict[str, torch.Tensor],
                cache: Params):
    """One token step.  batch: {"token": (B,1)} (a "pos" is not read)."""
    h, _, cache = forward(cfg, p, {"tokens": batch["token"]}, cache=cache)
    logits = blocks.logits_fn(cfg, p, h)[:, 0]
    return logits, cache
