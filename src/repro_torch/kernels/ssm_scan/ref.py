"""The plain PyTorch versions of the Mamba2 selective scan: the CPU path of
``ops.selective_scan`` and the functions the kernel is held to on the card.

Per (batch, head), head dim P and state dim N, with a scalar decay a and a
scalar skip d per head, from the state h_0 (zero unless given):

    h_t = exp(dt_t a) h_{t-1} + (dt_t x_t) b_t^T
    y_t = h_t c_t + d x_t

``selective_scan_ref`` is the model layout: x (B,T,H,P), b and c (B,T,N)
(one group, shared by every head), dt (B,T,H), a and d (H,).
``ssm_scan_ref`` is the counterpart of the reference's
``kernels/ssm_scan/ref.py: ssm_scan_ref``, the flat layout: x (BH,T,P), b
and c (BH,T,N), dt (BH,T), a and d (BH,), each row one head of its own
batch row.  Both step through time one token at a time in float32 and
return y in x's dtype and the final state in float32.

``selective_scan_bwd_ref`` is the gradient of ``selective_scan_ref``,
the reverse recurrence in float32: the CPU path of
``ops.SelectiveScan``'s backward and the function the backward kernels
(``csrc/ssm_backward.cu``) are held to on the card;
``ssd_bwd_chunked_ref`` is those kernels' algorithm, the chunked SSD form
with its float64 segment sums, exact or in their 3xTF32 rounding.

``ssd_chunked_ref`` and ``ssm_decode_rows_ref`` are the two Hopper
kernels' algorithms (``csrc/ssm_chunked.cu``, ``csrc/ssm_decode.cu``) in
the model layout, step for step: the chunked SSD form with its float64
segment sums and, on request, its 3xTF32 rounding of the products'
operands; the decode kernel's split of a state row over lanes and its
order of summation.  The CPU tests hold them to the reference; nothing on
the main path calls them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._fp import butterfly as _butterfly
from repro_torch.kernels._fp import decode_lanes
from repro_torch.kernels._fp import matmul as _matmul


def _scan(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
          dt: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
          h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,T,H,P), b and c (B,T,N), dt (B,T,H) float32; a and d
    broadcastable to (B,H); h (B,H,P,N) float32 -> (y (B,T,H,P), h)."""
    ys = []
    for t in range(x.shape[1]):
        dtt = dt[:, t]  # (B,H)
        decay = torch.exp(dtt * a)
        upd = (dtt[..., None] * x[:, t])[..., None] * b[:, t, None, None, :]
        h = decay[..., None, None] * h + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, c[:, t])
                  + d[..., None] * x[:, t])
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros(x.shape, dtype=torch.float32, device=x.device))
    return y, h


def selective_scan_ref(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                       dt: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                       state0: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,T,H,P); b, c (B,T,N); dt (B,T,H); a, d (H,); state0
    (B,H,P,N) -> (y (B,T,H,P), state (B,H,P,N) float32)."""
    B, T, H, P = x.shape
    N = b.shape[-1]
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if state0 is None else state0.float())
    y, h = _scan(*(t.float() for t in (x, b, c, dt, a, d)), h)
    return y.to(x.dtype), h


def selective_scan_bwd_ref(x: torch.Tensor, b: torch.Tensor,
                           c: torch.Tensor, dt: torch.Tensor,
                           a: torch.Tensor, d: torch.Tensor,
                           state0: Optional[torch.Tensor], dy: torch.Tensor,
                           dstate: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, ...]:
    """The gradients of ``selective_scan_ref``: x, dy (B,T,H,P); b, c
    (B,T,N); dt (B,T,H); a, d (H,); state0 and the final state's gradient
    ``dstate`` (B,H,P,N) or None (zero) -> (dx (B,T,H,P), db, dc (B,T,N),
    ddt (B,T,H), da, dd (H,), dstate0 (B,H,P,N)), all float32.

    The reverse recurrence, per (batch, head), with e_t = exp(dt_t a) and
    G_t = dL/dh_t = dy_t c_t^T + e_{t+1} G_{t+1} (G_T also gets dstate):
    dx_t = dt_t G_t b_t + d dy_t, db_t = sum_h dt_t G_t^T x_t,
    dc_t = sum_h h_t^T dy_t, ddt_t = sum G_t (a e_t h_{t-1} + x_t b_t^T),
    da = sum_{b,t} dt_t e_t sum G_t h_{t-1}, dd = sum_{b,t,p} dy x,
    dstate0 = e_1 G_1.  h_{t-1} comes from a forward pass that keeps every
    state."""
    B, T, H, P = x.shape
    N = b.shape[-1]
    x, b, c, dt, a, d, dy = (t.float() for t in (x, b, c, dt, a, d, dy))
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if state0 is None else state0.float())
    e = torch.exp(dt * a)  # (B,T,H)
    u = dt[..., None] * x  # (B,T,H,P)
    prev = []
    for t in range(T):
        prev.append(h)
        h = (e[:, t, :, None, None] * h
             + u[:, t, :, :, None] * b[:, t, None, None, :])
    G = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if dstate is None else dstate.float())
    dx = torch.empty_like(x)
    db, dc = (torch.empty((B, T, N), dtype=torch.float32, device=x.device)
              for _ in range(2))
    ddt = torch.empty_like(dt)
    da = torch.zeros_like(a)
    for t in reversed(range(T)):
        et = e[:, t, :, None, None]
        G = G + dy[:, t, :, :, None] * c[:, t, None, None, :]
        ht = et * prev[t] + u[:, t, :, :, None] * b[:, t, None, None, :]
        gb = torch.einsum("bhpn,bn->bhp", G, b[:, t])
        gh = (G * prev[t]).sum((-1, -2))  # (B,H)
        dx[:, t] = dt[:, t, :, None] * gb + d[:, None] * dy[:, t]
        db[:, t] = torch.einsum("bhpn,bhp->bn", G, u[:, t])
        dc[:, t] = torch.einsum("bhpn,bhp->bn", ht, dy[:, t])
        ddt[:, t] = a * e[:, t] * gh + (x[:, t] * gb).sum(-1)
        da += (dt[:, t] * e[:, t] * gh).sum(0)
        G = et * G
    dd = (dy * x).sum((0, 1, 3))
    return dx, db, dc, ddt, da, dd, G


def ssm_scan_ref(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 dt: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                 state0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (BH,T,P); b, c (BH,T,N); dt (BH,T); a, d (BH,); state0 (BH,P,N)
    -> (y (BH,T,P), state (BH,P,N) float32): each row a batch row of one
    head of its own (a, d), the model layout's one-head case."""
    BH, T, P = x.shape
    N = b.shape[-1]
    h = (torch.zeros((BH, 1, P, N), dtype=torch.float32, device=x.device)
         if state0 is None else state0.float()[:, None])
    y, h = _scan(x.float()[:, :, None], b.float(), c.float(),
                 dt.float()[..., None], a.float()[:, None],
                 d.float()[:, None], h)
    return y[:, :, 0].to(x.dtype), h[:, 0]


def ssd_chunked_ref(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    dt: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                    state0: Optional[torch.Tensor] = None, chunk: int = 64,
                    operand_rounding: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked kernel's algorithm: ``selective_scan_ref``'s function
    (same arguments and results) by Mamba2's chunked SSD form.

    T is cut into chunks of ``chunk`` steps, the last padded with dt = 0
    (the identity step).  In a chunk, with la = dt a (float32) and its
    prefix sums pfx taken in float64 from the chunk's start:
    G = C B^T; M[t, s] = exp(pfx_t - pfx_s) dt_s G[t, s] for s <= t;
    y = M x + exp(pfx_t) (C h^T) + d x; and the state
    h = exp(pfx_last) h + (x exp(pfx_last - pfx_s) dt_s)^T B, each
    difference of prefix sums taken in float64 and rounded to float32
    only in front of exp.  ``operand_rounding`` rounds the products'
    operands as ``_matmul`` says ("tf32x3" is the kernel's)."""
    B, T, H, P = x.shape
    N = b.shape[-1]
    x, b, c, dt, a, d = (t.float() for t in (x, b, c, dt, a, d))
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if state0 is None else state0.float().clone())
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    ys = []
    for t0 in range(0, T, chunk):
        n = min(chunk, T - t0)

        def piece(v):  # steps t0..t0+n of v, zero-padded to the chunk
            v = v[:, t0:t0 + n]
            return torch.cat([v, v.new_zeros((B, chunk - n, *v.shape[2:]))],
                             1)

        xc, bc, cc, dtc = piece(x), piece(b), piece(c), piece(dt)
        pfx = torch.cumsum((dtc * a).double(), 1)  # (B, C, H)
        total = pfx[:, -1]  # (B, H)
        seg = (pfx[:, :, None] - pfx[:, None]).float()  # (B, t, s, H)
        e = torch.exp(pfx.float())
        w = torch.exp((total[:, None] - pfx).float()) * dtc
        g = _matmul(cc, bc.transpose(1, 2), operand_rounding)  # (B, t, s)
        m = torch.where(mask[None, :, :, None],
                        torch.exp(seg) * dtc[:, None] * g[..., None], 0.0)
        xh = xc.permute(0, 2, 1, 3)  # (B, H, s, p)
        y = (_matmul(m.permute(0, 3, 1, 2), xh, operand_rounding)
             + e.transpose(1, 2)[..., None] * _matmul(
                 cc[:, None], h.transpose(-1, -2), operand_rounding)
             + d[:, None, None] * xh)  # (B, H, t, p)
        ys.append(y[:, :, :n].transpose(1, 2))
        xw = (xc * w[..., None]).permute(0, 2, 3, 1)  # (B, H, p, s)
        h = (torch.exp(total.float())[..., None, None] * h
             + _matmul(xw, bc[:, None], operand_rounding))
    y = (torch.cat(ys, 1) if ys else
         torch.zeros((B, 0, H, P), dtype=torch.float32, device=x.device))
    return y, h


def ssm_decode_rows_ref(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                        dt: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                        state0: Optional[torch.Tensor] = None,
                        lanes: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decode kernel's algorithm: ``selective_scan_ref``'s function
    step by step, with y_p summed as the kernel sums it.  A state row of N
    is split over ``lanes`` lanes (default the kernel's, ``decode_lanes``),
    4 consecutive n a lane; a lane adds its 4 products in n order, and the
    lanes' partials are added by the xor butterfly."""
    B, T, H, P = x.shape
    N = b.shape[-1]
    lanes = decode_lanes(N) if lanes is None else lanes
    if lanes < 1 or lanes & (lanes - 1) or 4 * lanes < N:
        raise ValueError(f"lanes must be a power of two with 4 lanes >= N = "
                         f"{N}, got {lanes}")
    x, b, c, dt, a, d = (t.float() for t in (x, b, c, dt, a, d))
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if state0 is None else state0.float().clone())
    pad = 4 * lanes - N
    ys = []
    for t in range(T):
        decay = torch.exp(dt[:, t] * a)[..., None, None]  # (B, H, 1, 1)
        u = (dt[:, t, :, None] * x[:, t])[..., None]  # (B, H, P, 1)
        h = decay * h + u * b[:, t, None, None, :]
        prod = h * c[:, t, None, None, :]
        prod = torch.cat([prod, prod.new_zeros((B, H, P, pad))], -1)
        prod = prod.reshape(B, H, P, lanes, 4)
        part = prod[..., 0]
        for i in range(1, 4):
            part = part + prod[..., i]
        ys.append(_butterfly(list(part.unbind(-1))) + d[:, None] * x[:, t])
    y = (torch.stack(ys, 1) if ys else
         torch.zeros((B, 0, H, P), dtype=torch.float32, device=x.device))
    return y, h


def ssd_bwd_chunked_ref(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                        dt: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                        state0: Optional[torch.Tensor], dy: torch.Tensor,
                        dstate: Optional[torch.Tensor] = None, *,
                        chunk: int = 64,
                        operand_rounding: Optional[str] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """The backward kernels' algorithm (``csrc/ssm_backward.cu``):
    ``selective_scan_bwd_ref``'s function (same arguments and results) by
    the chunked SSD form, division-free.

    T is cut into chunks of ``chunk`` steps, the last padded with dt = 0
    (the identity step).  In a chunk, la = dt a (float32), its prefix sums
    pfx in float64 from the chunk's start, every difference of them taken
    in float64 and rounded to float32 only in front of exp: e_t =
    exp(pfx_t), the chunk's decay exp(pfx_L), w_s = exp(pfx_L - pfx_s)
    dt_s, L[t,s] = exp(pfx_t - pfx_s) dt_s (s <= t).  (1) The state h_b at
    each chunk's start, walking forward: h <- exp(pfx_L) h + (diag(w) X)^T
    B.  (2) The state's gradient dh_e at each chunk's end, walking
    backward: dh <- exp(pfx_L) dh + (diag(e) dY)^T C (dstate0 the last).
    (3) Every chunk and head alone, with G = C B^T, M = L G, dM = dY X^T
    (s <= t), dG = dM L:  dx = M^T dY + (diag(w) B) dh_e^T + d dY;
    db = diag(w) X dh_e + dG^T C and dc = (diag(e) dY) h_b + dG B, each
    head's share, summed over heads in order;  the gradient of la_q,
    sum_{t>=q, s<q} (dM M)[t,s] + sum_{t>=q} I_t + exp(pfx_L) <dh_e, h_b>
    + sum_{s<q} w_s J_s (I_t = c_t . (e dY h_b)_t, J_s = b_s . (X dh_e)_s:
    the gradients through the segment sums, e and the state's decays),
    taken as one exclusive prefix sum in float64, gives ddt_q = a dla_q +
    sum_t (dM G exp(pfx_t - pfx_q))[t,q] + J_q exp(pfx_L - pfx_q) and da =
    sum dt dla over chunks, then batch rows, in order.
    ``operand_rounding`` rounds the products' operands as ``_matmul`` says
    ("tf32x3" is the kernels')."""
    B, T, H, P = x.shape
    N = b.shape[-1]
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    x, b, c, dt, a, d, dy = (t.float() for t in (x, b, c, dt, a, d, dy))
    dev = x.device
    C = chunk
    n = -(-T // C)

    def pieces(v):  # (B,T,...) -> (B,n,C,...), T zero-padded
        v = torch.cat([v, v.new_zeros((B, n * C - T, *v.shape[2:]))], 1)
        return v.reshape(B, n, C, *v.shape[2:])

    # heads first: x, dy (B,H,n,C,P); dt (B,H,n,C); b, c (B,1,n,C,N)
    xc, dyc = (pieces(v).permute(0, 3, 1, 2, 4) for v in (x, dy))
    dtc = pieces(dt).permute(0, 3, 1, 2)
    bc, cc = (pieces(v)[:, None] for v in (b, c))
    pfx = torch.cumsum((dtc * a[None, :, None, None]).double(), -1)
    total = pfx[..., -1:]
    e = torch.exp(pfx.float())
    wts = torch.exp((total - pfx).float()) * dtc
    decay = torch.exp(total.float())[..., None]  # (B,H,n,1,1)

    def mm(p, q):
        return _matmul(p, q, operand_rounding)

    # (1) and (2): the boundary states and gradients
    zeros = torch.zeros((B, H, P, N), dtype=torch.float32, device=dev)
    h = zeros if state0 is None else state0.float()
    hb = []
    for i in range(n):
        hb.append(h)
        h = decay[:, :, i] * h + mm((xc[:, :, i] * wts[:, :, i, :, None])
                                    .transpose(-1, -2), bc[:, :, i])
    g = zeros if dstate is None else dstate.float()
    dhe = [None] * n
    for i in reversed(range(n)):
        dhe[i] = g
        g = decay[:, :, i] * g + mm((dyc[:, :, i] * e[:, :, i, :, None])
                                    .transpose(-1, -2), cc[:, :, i])
    hb, dhe = torch.stack(hb, 2), torch.stack(dhe, 2)  # (B,H,n,P,N)
    # (3): every chunk and head
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool, device=dev))
    ex = torch.exp((pfx[..., :, None] - pfx[..., None, :]).float())
    L = torch.where(mask, ex * dtc[..., None, :], 0.0)  # (t, s)
    Gm = mm(cc, bc.transpose(-1, -2))
    M = L * Gm
    dM = torch.where(mask, mm(dyc, xc.transpose(-1, -2)), 0.0)
    dG = dM * L
    ydh = mm(dyc * e[..., None], hb)  # (t, n), e_t (dY h_b)
    xdh = mm(xc, dhe)  # (s, n)
    dx = (mm(M.transpose(-1, -2), dyc)
          + mm(bc * wts[..., None], dhe.transpose(-1, -2))
          + d[None, :, None, None, None] * dyc)
    dc = ydh + mm(dG, bc)
    db = wts[..., None] * xdh + mm(dG.transpose(-1, -2), cc)
    # the gradient of la through the segment sums, e and the decays: one
    # exclusive prefix sum in float64 of colsum(Q) - rowsum(Q) + w J - I,
    # Q = dM M strictly below the diagonal, from sum_t I_t + exp(pfx_L)
    # <dh_e, h_b>
    Q = torch.tril(dM * M, -1)
    I = (cc * ydh).sum(-1)  # (B,H,n,C)
    J = (bc * xdh).sum(-1)
    term = (Q.sum(-2).double() - Q.sum(-1).double()
            + (wts * J).double() - I.double())
    dla = ((torch.cumsum(term, -1) - term) + I.double().sum(-1, True)
           + (decay[..., 0] * (dhe * hb).sum((-1, -2))[..., None]).double())
    ddt = (a[None, :, None, None].double() * dla
           + torch.where(mask, dM * Gm * ex, 0.0).sum(-2).double()
           + (J * torch.exp((total - pfx).float())).double()).float()
    da = (dtc.double() * dla).sum(-1).float()

    def model_layout(v):  # (B,H,n,C,...) -> (B,T,H,...)
        v = v.reshape(B, H, n * C, *v.shape[4:])[:, :, :T]
        return v.permute(0, 2, 1, *range(3, v.dim())).contiguous()

    return (model_layout(dx), model_layout(db).sum(2),
            model_layout(dc).sum(2), model_layout(ddt), da.sum((0, 2)),
            (dy * x).sum((0, 1, 3)), g)
