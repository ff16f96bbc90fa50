"""#6's tensor-core backward on the CPU: its arithmetic and its geometry.

The bf16 route of the port's backward is two CUDA kernels
(``csrc/flash_backward_wgmma.cu``, ``bwd_dq_wgmma`` and ``bwd_dkdv_wgmma``)
that run only on the card (``chip_smoke.py`` phase 19 (a) holds them to
their plain versions there).  Here:

- ``ref.flash_attend_bwd_tc_ref``, the kernels' arithmetic (bf16 operands,
  P and dS applied as hi + lo bf16 parts, f32 sums), against ``jax.vjp``
  of the reference's ``attend`` in float32 on the same bf16-representable
  inputs: rounded to bf16 as the kernels store, within the bf16 gate the
  card holds them to (|d| <= 2^-8 |want| + 1e-3), which one bf16 rounding
  of P and dS misses at every shape; in float32 within 1e-4 (1 + |want|);
- ``kernel.bwd_tiling`` at every ``chip_smoke.FLASH_BWD_SHAPES`` shape and
  at G = 6, G = 80 and G = 3: the row tiles cover every (query, head) row once,
  every pair the positions let through lies in a live (row tile, key
  tile), a tile marked whole is attended by every pair, the runs split
  each key tile's live row tiles exactly, the grid reaches two waves of
  132 SMs where the rows allow, and the scratch sizes are the kernels'
  layout;
- ``kernel.bwd_kernel_for``'s rule, and the wrapper's refusal of a route
  that cannot take the call.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.models.attention import attend as attend_ref
from repro_torch.kernels.flash_attention import kernel, ref

STEP_RTOL, STEP_ATOL = 2.0**-8, 1e-3  # the bf16 gate on the card
F32_TOL = 1e-4

# label -> ((B, Sq, Sk, Hq, Hkv, D), causal, window, positions' kind)
SHAPES = {
    "d64 gqa causal": ((2, 40, 40, 8, 2, 64), True, 0, "arange"),
    "d120 window": ((2, 48, 48, 8, 2, 120), True, 16, "arange"),
    "d256 mqa": ((1, 20, 20, 8, 1, 256), True, 0, "arange"),
    "cross not causal": ((2, 8, 40, 4, 4, 64), False, 0, "cross"),
    "holes, a dead row": ((2, 30, 30, 4, 2, 64), True, 0, "holes_dead"),
}
# the tiling's shapes: phase 19 (a)'s, and G = 6 (grok's and nemotron's
# 48:8) and G = 80 (more heads than a row tile holds) with a ring buffer
TILING_SHAPES = {**chip_smoke.FLASH_BWD_SHAPES,
                 "g6 d128": ((2, 100, 130, 48, 8, 128), True, 0, "arange"),
                 "g80 ring": ((1, 9, 70, 80, 1, 64), True, 0, "ring"),
                 "g3 window": ((2, 33, 33, 3, 1, 8), False, 5, "arange")}


def positions(B, Sq, Sk, kind):
    """int32 (q_pos, kv_pos) as ``chip_smoke._flash_case`` makes them."""
    q_pos = np.tile(np.arange(Sk - Sq, Sk, dtype=np.int32), (B, 1))
    kv_pos = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    if kind == "cross":
        q_pos = np.zeros((B, Sq), np.int32)
    elif kind == "holes_dead":
        kv_pos[:, ::7] = -1
        kv_pos[min(1, B - 1), :50] = -1
        q_pos[0, 0] = -1
    elif kind == "ring":
        pos = np.arange(Sk // 3, Sk // 3 + Sk, dtype=np.int32)
        kv_pos[:, pos % Sk] = pos
        kv_pos[:, ::5] = -1
        q_pos = np.tile(pos[Sk - Sq:], (B, 1))
    return q_pos, kv_pos


def bf16_case(shape, kind, seed=3):
    """q, k, v, dO standard normal rounded to bf16 values (float32), and
    the positions."""
    B, Sq, Sk, Hq, Hkv, D = shape
    rng = np.random.default_rng(seed)
    arrays = [torch.tensor(rng.standard_normal(s), dtype=torch.float32)
              .to(torch.bfloat16).float().numpy()
              for s in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D),
                        (B, Sq, Hq, D))]
    return (*arrays, *positions(B, Sq, Sk, kind))


def jax_grads(q, k, v, do, q_pos, kv_pos, causal, window):
    """(o, dq, dk, dv) of the reference's chunked ``attend`` by
    ``jax.vjp``, chunk 16."""
    def f(q_, k_, v_):
        return attend_ref(q_, k_, v_, jnp.asarray(q_pos), jnp.asarray(kv_pos),
                          causal=causal, window=window, chunk=16)
    o, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return [torch.tensor(np.asarray(x)) for x in (o, *vjp(jnp.asarray(do)))]


def single_bf16_grads(q, k, v, o, do, q_pos, kv_pos, causal, window):
    """The tensor-core arithmetic with P and dS rounded once to bf16
    (nearest) in place of their hi + lo parts."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg, dog = (t.reshape(B, Sq, Hkv, G, D) for t in (q, do))
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg, k) * D**-0.5
    mask = ref.position_mask(q_pos, kv_pos, causal, window)[:, :, None, None]
    s = torch.where(mask, s, ref.NEG_INF)
    p = torch.where(mask, torch.exp(s - torch.logsumexp(s, -1, True)), 0.0)
    dp = torch.einsum("bqhgd,bkhd->bqhgk", dog, v)
    ds = p * (dp - (dog * o.reshape(B, Sq, Hkv, G, D)).sum(-1)[..., None])
    p, ds = (t.to(torch.bfloat16).float() for t in (p, ds))
    return (torch.einsum("bqhgk,bkhd->bqhgd", ds, k).reshape(q.shape)
            * D**-0.5,
            torch.einsum("bqhgk,bqhgd->bkhd", ds, qg) * D**-0.5,
            torch.einsum("bqhgk,bqhgd->bkhd", p, dog))


@pytest.mark.parametrize("label", SHAPES)
def test_tc_arithmetic_matches_jax_vjp(label):
    shape, causal, window, kind = SHAPES[label]
    q, k, v, do, q_pos, kv_pos = bf16_case(shape, kind)
    o, *want = jax_grads(q, k, v, do, q_pos, kv_pos, causal, window)
    t = [torch.tensor(x) for x in (q, k, v, do, q_pos, kv_pos)]
    got = ref.flash_attend_bwd_tc_ref(t[0], t[1], t[2], o, t[3], t[4], t[5],
                                      causal=causal, window=window)
    single = single_bf16_grads(t[0], t[1], t[2], o, t[3], t[4], t[5], causal,
                               window)
    f32_ratio, single_ratio = 0.0, 0.0
    for g, w, one in zip(got, want, single):
        assert g.shape == w.shape and g.dtype == torch.float32
        gate = STEP_RTOL * w.abs() + STEP_ATOL
        stored = g.to(torch.bfloat16).float()
        assert bool(((stored - w).abs() <= gate).all())
        f32_ratio = max(f32_ratio, float(
            ((g - w).abs() / (F32_TOL * (1 + w.abs()))).max()))
        single_ratio = max(single_ratio, float(
            ((one.to(torch.bfloat16).float() - w).abs() / gate).max()))
    assert f32_ratio <= 1.0
    # why P and dS go in as hi + lo: rounded once to bf16 they miss the
    # bf16 gate the card holds the stored gradients to
    assert single_ratio > 1.0
    dead = ~ref.position_mask(t[4], t[5], causal, window).any(-1)
    assert bool(dead.any()) == (kind == "holes_dead")
    assert bool((got[0][dead] == 0).all())


def test_hi_lo_split():
    x = torch.tensor([1.0, -3.14159265, 1e-20, 0.0, 123456.789, -2.0**-30])
    hi, lo = ref.bf16_hi_lo(x)
    assert torch.equal(hi.to(torch.bfloat16).float(), hi)  # hi is a bf16
    assert torch.equal(lo.to(torch.bfloat16).float(), lo)
    assert bool(((hi + lo - x).abs() <= 2.0**-16 * x.abs()).all())
    assert bool((hi.abs() <= x.abs()).all())  # cut toward zero


def row_slot(r, G, tl):
    """(row tile, slot 0..63) of (query, head) row r = i G + g of a KV
    head's group, as the kernels address the statistics (``RowTiles::slot``
    in csrc/flash_backward_wgmma.cu)."""
    i, g = divmod(r, G)
    return ((i // tl.qt) * tl.head_tiles + g // tl.gb,
            (i % tl.qt) * tl.gb + g % tl.gb)


def run_range(n_live, runs, run):
    """The positions in a key tile's list of live row tiles that run
    ``run`` of ``runs`` takes, as bwd_dkdv_wgmma splits them."""
    return n_live * run // runs, n_live * (run + 1) // runs


def live_tiles(tl, G, Sq, Sk, q_pos, kv_pos, causal, window):
    """For one batch row: {key tile: [(row tile, whole)] in order}, the
    kernels' superset test (csrc/flash_backward_wgmma.cu, bwd_dkdv)."""
    out = {}
    for kt in range(tl.key_tiles):
        kp = kv_pos[kt * 64:(kt + 1) * 64]
        written = kp[kp >= 0]
        live_rows = []
        for t in range(tl.row_tiles):
            i0 = (t // tl.head_tiles) * tl.qt
            g0 = (t % tl.head_tiles) * tl.gb
            qp = q_pos[i0:min(i0 + tl.qt, Sq)]
            lo, hi = qp.min(), qp.max()
            live = written.size > 0 and (
                not causal or written.min() <= hi) and (
                window <= 0 or lo - written.max() < window)
            whole = (len(written) == 64 and tl.gb * tl.qt == 64
                     and i0 + tl.qt <= Sq and g0 + tl.gb <= G
                     and (not causal or written.max() <= lo)
                     and (window <= 0 or hi - written.min() < window))
            if live:
                live_rows.append((t, whole))
        out[kt] = live_rows
    return out


@pytest.mark.parametrize("label", TILING_SHAPES)
def test_bwd_tiling(label):
    shape, causal, window, kind = TILING_SHAPES[label]
    B, Sq, Sk, Hq, Hkv, D = shape
    G = Hq // Hkv
    tl = kernel.bwd_tiling(*shape)
    assert tl.gb * tl.qt <= kernel.BWD_TILE_ROWS
    # every (query, head) row in one slot of one row tile
    slots = {row_slot(r, G, tl) for r in range(Sq * G)}
    assert len(slots) == Sq * G
    assert all(0 <= t < tl.row_tiles and 0 <= n < tl.gb * tl.qt
               for t, n in slots)
    q_pos, kv_pos = positions(B, Sq, Sk, kind)
    mask = ref.position_mask(torch.tensor(q_pos), torch.tensor(kv_pos),
                             causal, window).numpy()
    for b in range(B):
        tiles = live_tiles(tl, G, Sq, Sk, q_pos[b], kv_pos[b], causal,
                           window)
        for kt, rows in tiles.items():
            live = {t for t, _ in rows}
            # the runs take each live row tile of the key tile exactly once
            taken = [t for run in range(tl.runs)
                     for t, _ in rows[slice(*run_range(
                         len(rows), tl.runs, run))]]
            assert taken == [t for t, _ in rows]
            for t, whole in rows:
                i0 = (t // tl.head_tiles) * tl.qt
                block = mask[b, i0:i0 + tl.qt, kt * 64:(kt + 1) * 64]
                if whole:
                    assert block.shape == (tl.qt, 64) and block.all()
            # every pair the positions let through lies in a live tile
            i, j = np.nonzero(mask[b, :, kt * 64:(kt + 1) * 64])
            for qi in np.unique(i):
                for g in range(G):
                    t, _ = row_slot(qi * G + g, G, tl)
                    assert t in live, (b, kt, qi, g)
    units = B * Hkv * tl.key_tiles * tl.split
    assert tl.dkdv_blocks == units * tl.runs
    assert tl.dkdv_blocks >= kernel.BWD_MIN_BLOCKS or tl.runs == tl.row_tiles
    assert tl.split == (2 if D > 128 else 1)
    # the kernels' scratch: (lse, delta) for 64 slots a row tile; f32 dK and
    # dV of 64 keys by the block's panels for each (unit, run); a counter a
    # unit
    assert tl.stats_numel == 2 * 64 * tl.row_tiles * B * Hkv
    out_cols = 64 * tl.panels // tl.split
    assert tl.partial_numel == (units * tl.runs * 2 * 64 * out_cols
                                if tl.runs > 1 else 0)
    assert tl.counters == (units if tl.runs > 1 else 0)
    assert tl.dq_blocks == -(-Sq * G // (128 if D <= 128 else 64)) \
        * tl.split * Hkv * B


def test_bwd_kernel_for_rule():
    bf, f32 = torch.bfloat16, torch.float32
    assert kernel.bwd_kernel_for(64, bf) == "wgmma"
    assert kernel.bwd_kernel_for(120, bf) == "wgmma"
    assert kernel.bwd_kernel_for(256, bf) == "wgmma"
    assert kernel.bwd_kernel_for(8, bf) == "wgmma"
    assert kernel.bwd_kernel_for(12, bf) == "simt"
    assert kernel.bwd_kernel_for(64, f32) == "simt"
    assert kernel.bwd_kernel_for(256, f32) == "simt"
    assert set(kernel.BWD_KERNELS) == {
        n for pair in kernel.BWD_ROUTES.values() for n in pair}
    q = torch.zeros(1, 4, 2, 64)
    pos = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="route 'wgmma' cannot take"):
        kernel.flash_attention_backward(q, q, q, q, q, pos, pos,
                                        kernel="wgmma")
    with pytest.raises(ValueError, match="route 'tiles' cannot take"):
        kernel.flash_attention_backward(q, q, q, q, q, pos, pos,
                                        kernel="tiles")
