"""The plain PyTorch versions of the RWKV6 WKV scan: the CPU path of
``ops.wkv`` and the functions the kernel is held to on the card.

Per (batch, head), head size N, from the state S_0 (zero unless given):

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

``wkv_ref`` is the model layout, r, k, v, w (B,T,H,N) and u (H,N);
``rwkv6_scan_ref`` is the counterpart of the reference's
``kernels/rwkv6_scan/ref.py: rwkv6_scan_ref``, the flat (BH,T,N) layout
with u (BH,N): the model layout's BH heads of one batch row.  Both step through time one token at a time
in float32 and return y in r's dtype and the final state in float32.

``wkv_bwd_ref`` is the gradient of ``wkv_ref``, the reverse recurrence in
float32: the CPU path of ``ops.WKV``'s backward and the function the
backward kernels (``csrc/rwkv6_backward.cu``) are held to on the card;
``wkv_bwd_chunked_ref`` is those kernels' algorithm, the chunked form
with dw division-free, exact or in their 3xTF32 rounding.

``wkv_chunked_ref`` and ``wkv_decode_rows_ref`` are the two Hopper
kernels' algorithms (``csrc/rwkv6_chunked.cu``, ``csrc/rwkv6_decode.cu``)
in the model layout, step for step: the chunked form with its decays as
running products of w and, on request, its 3xTF32 rounding of the
products' operands; the decode kernel's split of a state column over lanes
and its order of summation.  The CPU tests hold them to the reference;
nothing on the main path calls them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._fp import butterfly, decode_lanes, matmul


def wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor,
            state0: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (B,T,H,N); u (H,N); state0 (B,H,N,N) -> (y (B,T,H,N),
    state (B,H,N,N) float32)."""
    B, T, H, N = r.shape
    S = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float())
    uf = u.float()[..., None]  # (H,N,1)
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    ys = []
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]  # (B,H,N,N)
        ys.append(torch.einsum("bhn,bhnm->bhm", rf[:, t], S + uf * kv))
        S = wf[:, t, :, :, None] * S + kv
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros((B, 0, H, N), dtype=torch.float32, device=r.device))
    return y.to(r.dtype), S


def wkv_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor,
                state0: Optional[torch.Tensor], dy: torch.Tensor,
                dstate: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, ...]:
    """The gradients of ``wkv_ref``: r, k, v, w, dy (B,T,H,N); u (H,N);
    state0 and the final state's gradient ``dstate`` (B,H,N,N) or None
    (zero) -> (dr, dk, dv, dw (B,T,H,N), du (H,N), dstate0 (B,H,N,N)),
    all float32.

    The reverse recurrence, per (batch, head), with G_t = dL/dS_t from
    G_T = dstate: dr_t = (S_{t-1} + diag(u) k_t v_t^T) dy_t,
    dk_t = u r_t (v_t . dy_t) + G_t v_t, dv_t = (r_t . u k_t) dy_t +
    G_t^T k_t, dw_t = rowsum(G_t S_{t-1}), du = sum_{b,t} r_t k_t
    (v_t . dy_t), G_{t-1} = diag(w_t) G_t + r_t dy_t^T, dstate0 = G_0.
    S_{t-1} comes from a forward pass that keeps every state."""
    B, T, H, N = r.shape
    r, k, v, w, dy = (a.float() for a in (r, k, v, w, dy))
    u = u.float()
    S = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float())
    prev = []
    for t in range(T):
        prev.append(S)
        S = w[:, t, :, :, None] * S + k[:, t, :, :, None] * v[:, t, :, None]
    G = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
         if dstate is None else dstate.float())
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros((H, N), dtype=torch.float32, device=r.device)
    for t in reversed(range(T)):
        rt, kt, vt, wt, dyt = (a[:, t] for a in (r, k, v, w, dy))
        vdy = (vt * dyt).sum(-1, keepdim=True)  # (B,H,1)
        dr[:, t] = torch.einsum("bhij,bhj->bhi", prev[t], dyt) + u * kt * vdy
        dk[:, t] = torch.einsum("bhij,bhj->bhi", G, vt) + u * rt * vdy
        dv[:, t] = (torch.einsum("bhij,bhi->bhj", G, kt)
                    + (u * rt * kt).sum(-1, keepdim=True) * dyt)
        dw[:, t] = (G * prev[t]).sum(-1)
        du += (rt * kt * vdy).sum(0)
        G = wt[..., None] * G + rt[..., None] * dyt[..., None, :]
    return dr, dk, dv, dw, du, G


def to_model_layout(x: torch.Tensor) -> torch.Tensor:
    """(BH,T,N) -> (1,T,BH,N), contiguous: BH heads of one batch row."""
    return x.transpose(0, 1)[None].contiguous()


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor,
                   state0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (BH,T,N); u (BH,N); state0 (BH,N,N) -> (y (BH,T,N),
    state (BH,N,N) float32): ``wkv_ref`` on ``to_model_layout``."""
    y, S = wkv_ref(*map(to_model_layout, (r, k, v, w)), u,
                   None if state0 is None else state0[None])
    return y[0].transpose(0, 1), S[0]


def wkv_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor,
                    state0: Optional[torch.Tensor] = None, *,
                    chunk: int = 16, cols: int = 32,
                    operand_rounding: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked kernel's algorithm: ``wkv_ref``'s function (same
    arguments and results, y float32) by the chunked WKV form.

    T is cut into chunks of ``chunk`` steps, the last zero-padded.  In a
    chunk of n real steps, every product of w a running product of its
    factors in step order: D_t = prod_{q < t} w_q and r~_t = r_t D_t;
    k~_s = k_s prod_{s < q < n} w_q; A[t, s] = sum_i r_t,i k_s,i
    prod_{s < q < t} w_q,i for s < t (r_t multiplied by w_{t-1}, w_{t-2},
    ... as s walks down), A[t, t] = sum_i (r_t,i u_i) k_t,i (the bonus);
    then, per block of ``cols`` value columns (the kernel's grid), y =
    r~ S + A V and S = diag(D_n) S + k~^T V.  ``operand_rounding`` rounds
    the three products' operands as ``_fp.matmul`` says ("tf32x3" is the
    kernel's)."""
    B, T, H, N = r.shape
    if chunk < 1 or cols < 1:
        raise ValueError(f"chunk and cols must be >= 1, got {chunk}, {cols}")
    r, k, v, w, u = (t.float() for t in (r, k, v, w, u))
    S = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float().clone())
    ys = []
    for t0 in range(0, T, chunk):
        n = min(chunk, T - t0)

        def piece(a):  # steps t0..t0+n, zero-padded to the chunk: (B,H,C,N)
            a = a[:, t0:t0 + n].permute(0, 2, 1, 3)
            return torch.cat([a, a.new_zeros((B, H, chunk - n, N))], 2)

        rc, kc, vc, wc = piece(r), piece(k), piece(v), piece(w)
        D = torch.ones((B, H, N), dtype=torch.float32, device=r.device)
        rt = torch.empty_like(rc)
        for t in range(chunk):
            rt[:, :, t] = rc[:, :, t] * D
            if t < n:
                D = D * wc[:, :, t]
        E = torch.ones_like(D)
        kt = torch.zeros_like(kc)
        for s in reversed(range(n)):
            kt[:, :, s] = kc[:, :, s] * E
            E = E * wc[:, :, s]
        A = torch.zeros((B, H, chunk, chunk), dtype=torch.float32,
                        device=r.device)
        A[:, :, range(chunk), range(chunk)] = (rc * u[None, :, None]
                                               * kc).sum(-1)
        qv = rc.clone()
        for m in range(chunk - 1):  # the pairs (t, t - 1 - m)
            ts = torch.arange(m + 1, chunk, device=r.device)
            if m > 0:
                qv[:, :, ts] = qv[:, :, ts] * wc[:, :, ts - m]
            A[:, :, ts, ts - 1 - m] = (qv[:, :, ts]
                                       * kc[:, :, ts - 1 - m]).sum(-1)
        y = torch.empty_like(vc)
        for j0 in range(0, N, cols):
            Vb, Sb = vc[..., j0:j0 + cols], S[..., j0:j0 + cols]
            y[..., j0:j0 + cols] = (matmul(rt, Sb, operand_rounding)
                                    + matmul(A, Vb, operand_rounding))
            S[..., j0:j0 + cols] = D[..., None] * Sb + matmul(
                kt.transpose(-1, -2), Vb, operand_rounding)
        ys.append(y[:, :, :n].permute(0, 2, 1, 3))
    y = (torch.cat(ys, 1) if ys else
         torch.zeros((B, 0, H, N), dtype=torch.float32, device=r.device))
    return y, S


def wkv_decode_rows_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, u: torch.Tensor,
                        state0: Optional[torch.Tensor] = None,
                        lanes: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decode kernel's algorithm: ``wkv_ref``'s function step by step
    (y float32), with y_j summed as the kernel sums it.  A state column of
    N is split over ``lanes`` lanes (default the kernel's,
    ``decode_lanes``), 4 consecutive rows i a lane; a lane adds its 4 terms
    r_i (S[i][j] + (u_i k_i) v_j) in i order, and the lanes' partials are
    added by the xor butterfly."""
    B, T, H, N = r.shape
    lanes = decode_lanes(N) if lanes is None else lanes
    if lanes < 1 or lanes & (lanes - 1) or 4 * lanes < N:
        raise ValueError(f"lanes must be a power of two with 4 lanes >= N = "
                         f"{N}, got {lanes}")
    r, k, v, w, u = (t.float() for t in (r, k, v, w, u))
    S = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float().clone())
    pad = 4 * lanes - N
    ys = []
    for t in range(T):
        rt, kt, vt, wt = (a[:, t] for a in (r, k, v, w))  # (B,H,N)
        uk = u * kt
        terms = rt[..., None] * (S + uk[..., None] * vt[..., None, :])
        terms = torch.cat([terms, terms.new_zeros((B, H, pad, N))], 2)
        terms = terms.reshape(B, H, lanes, 4, N)
        part = terms[:, :, :, 0]
        for i in range(1, 4):
            part = part + terms[:, :, :, i]
        ys.append(butterfly(list(part.unbind(2))))
        S = wt[..., None] * S + kt[..., None] * vt[..., None, :]
    y = (torch.stack(ys, 1) if ys else
         torch.zeros((B, 0, H, N), dtype=torch.float32, device=r.device))
    return y, S


def _chunks(a: torch.Tensor, chunk: int, fill: float) -> torch.Tensor:
    """(B,T,H,N) -> (B,H,T/chunk,chunk,N), T padded with ``fill``."""
    B, T, H, N = a.shape
    n = -(-T // chunk)
    a = a.permute(0, 2, 1, 3)
    a = torch.cat([a, a.new_full((B, H, n * chunk - T, N), fill)], 2)
    return a.reshape(B, H, n, chunk, N)


def wkv_bwd_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, u: torch.Tensor,
                        state0: Optional[torch.Tensor], dy: torch.Tensor,
                        dstate: Optional[torch.Tensor] = None, *,
                        chunk: int = 16,
                        operand_rounding: Optional[str] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """The backward kernels' algorithm (``csrc/rwkv6_backward.cu``):
    ``wkv_bwd_ref``'s function (same arguments and results) by the chunked
    form, division-free.

    T is cut into chunks of ``chunk`` steps, the last padded with the
    identity step (w = 1, r = k = v = dy = 0).  In a chunk, every decay a
    running product of its w's in step order: D_t = prod_{q<t} w_q,
    E_t = prod_{t<q<C} w_q, P(s,t) = prod_{s<q<t} w_q; r~ = r D, k~ = k E.
    (1) The state S_b at each chunk's start, walking forward:
    S <- diag(D_C) S + k~^T V.  (2) The state's gradient G_e at each
    chunk's end, walking backward: G <- diag(D_C) G + r~^T dY (dstate0 the
    last).  (3) Every chunk alone, with Y2 = dY S_b^T, X = V G_e^T,
    B2 = dY V^T and A the forward's (running products, the bonus on the
    diagonal):  dv = k~ G_e + A^T dY;  per column i, walking t down with
    R_s(t) = sum_{s'>t} P(t,s') r_s' B2[s',s]:
    dr_t = D_t Y2_t + sum_{s<t} P(s,t) k_s B2[t,s] + u k_t B2[t,t],
    dk_t = E_t X_t + R_t(t) + u r_t B2[t,t], du += r_t k_t B2[t,t], and
    dw_t = rowsum(G_t S_{t-1}) in four terms: E_t Z_t (Z_0 = rowsum(G_e
    S_b), Z_{t+1} = w_t Z_t + k_t X_t: the term D_t E_t rowsum(G_e S_b)
    and the G_e-V cross term), D_t W_t (W = sum_{s'>t} P(t,s') r_s' Y2_s',
    the S_b-dY cross term) and sum_{s<t} P(s,t) k_s R_s(t) (the pairs
    s < t < s').  ``operand_rounding`` rounds the products' operands as
    ``_fp.matmul`` says ("tf32x3" is the kernels')."""
    B, T, H, N = r.shape
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    r, k, v, w, dy = (a.float() for a in (r, k, v, w, dy))
    u = u.float()
    dev = r.device
    C = chunk
    rc, kc, vc, dyc = (_chunks(a, C, 0.0) for a in (r, k, v, dy))
    wc = _chunks(w, C, 1.0)
    n = rc.shape[2]
    D = [torch.ones_like(wc[:, :, :, 0])]
    for t in range(C):
        D.append(D[-1] * wc[:, :, :, t])
    E = [torch.ones_like(D[0])]
    for t in reversed(range(1, C)):
        E.insert(0, E[0] * wc[:, :, :, t])
    D, dc = torch.stack(D[:C], 3), D[C]  # (B,H,n,C,N), (B,H,n,N)
    E = torch.stack(E, 3)
    rt, kt = rc * D, kc * E

    def mm(a, b):
        return matmul(a, b, operand_rounding)

    # (1) and (2): the boundary states and gradients
    zeros = torch.zeros((B, H, N, N), dtype=torch.float32, device=dev)
    S = zeros if state0 is None else state0.float()
    Sb = []
    for c in range(n):
        Sb.append(S)
        S = dc[:, :, c, :, None] * S + mm(kt[:, :, c].transpose(-1, -2),
                                          vc[:, :, c])
    G = zeros if dstate is None else dstate.float()
    Ge = [None] * n
    for c in reversed(range(n)):
        Ge[c] = G
        G = dc[:, :, c, :, None] * G + mm(rt[:, :, c].transpose(-1, -2),
                                          dyc[:, :, c])
    Sb, Ge = torch.stack(Sb, 2), torch.stack(Ge, 2)  # (B,H,n,N,N)
    # (3): every chunk's products
    Y2 = mm(dyc, Sb.transpose(-1, -2))  # (t, i)
    X = mm(vc, Ge.transpose(-1, -2))  # (s, i)
    B2 = mm(dyc, vc.transpose(-1, -2))  # (t, s)
    A = torch.zeros((B, H, n, C, C), dtype=torch.float32, device=dev)
    A[..., range(C), range(C)] = (rc * u[None, :, None, None] * kc).sum(-1)
    for t in range(C):
        q = rc[:, :, :, t]
        for s in reversed(range(t)):
            A[..., t, s] = (q * kc[:, :, :, s]).sum(-1)
            q = q * wc[:, :, :, s]
    dv = mm(kt, Ge) + mm(A.transpose(-1, -2), dyc)
    # per column i: the recurrences over t and the pairs
    uu = u[None, :, None]
    Z = (Ge * Sb).sum(-1)
    EZ = []
    for t in range(C):
        EZ.append(E[:, :, :, t] * Z)
        Z = wc[:, :, :, t] * Z + kc[:, :, :, t] * X[:, :, :, t]
    R = [torch.zeros_like(Z) for _ in range(C)]
    W = torch.zeros_like(Z)
    du = torch.zeros_like(Z)
    dr, dk, dw = (torch.empty_like(rc) for _ in range(3))
    for t in reversed(range(C)):
        rt_, kt_, wt_ = rc[:, :, :, t], kc[:, :, :, t], wc[:, :, :, t]
        q = torch.ones_like(Z)
        acc_r, acc_w = torch.zeros_like(Z), torch.zeros_like(Z)
        for s in reversed(range(t)):
            kq = kc[:, :, :, s] * q
            acc_r = acc_r + B2[..., t, s, None] * kq
            acc_w = acc_w + R[s] * kq
            q = q * wc[:, :, :, s]
        bonus = B2[..., t, t, None]
        Dt, Et = D[:, :, :, t], E[:, :, :, t]
        dr[:, :, :, t] = Dt * Y2[:, :, :, t] + acc_r + uu * kt_ * bonus
        dk[:, :, :, t] = Et * X[:, :, :, t] + R[t] + uu * rt_ * bonus
        dw[:, :, :, t] = EZ[t] + Dt * W + acc_w
        du = du + rt_ * kt_ * bonus
        W = wt_ * W + rt_ * Y2[:, :, :, t]
        for s in range(t):
            R[s] = wt_ * R[s] + rt_ * B2[..., t, s, None]

    def model_layout(a):  # (B,H,n,C,N) -> (B,T,H,N)
        return a.reshape(B, H, n * C, -1)[:, :, :T].permute(0, 2, 1, 3)

    return (*(model_layout(a).contiguous() for a in (dr, dk, dv, dw)),
            du.sum((0, 2)), G)
