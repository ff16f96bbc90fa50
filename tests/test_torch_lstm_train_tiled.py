"""The training pair's Hopper algorithms in plain PyTorch
(``ref.lstm_sequence_fwd_train_tiled_ref``, ``ref.lstm_sequence_bwd_tiled_ref``)
against the port's existing plain versions, the reference's Pallas kernels in
interpret mode and ``jax.grad`` through the reference's ``lax.scan``
(``repro.kernels.lstm_cell.ref.lstm_sequence_ref``), on the same numpy
inputs.

The CUDA kernels run only on a card; ``chip_smoke.py`` holds them to these
plain versions there, at the tiling the kernel reports.  Here the tilings are
the kernel's at the step shapes (2 rows a tile, dh over 32 lanes, 8 steps a
chunk) and others around it: one row a tile, tiles that leave a ragged last
one, chunks shorter than T, 1, 4 and 8 lanes.  Tolerance: atol = rtol =
1e-5, float32 sums taken in other orders than the reference's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lstm_cell.kernel import lstm_sequence_bwd as jax_bwd
from repro.kernels.lstm_cell.kernel import (
    lstm_sequence_fwd_train as jax_fwd_train,
)
from repro.kernels.lstm_cell.ref import lstm_sequence_ref as jax_scan
from repro_torch.kernels.lstm_cell import ref

TOL = dict(atol=1e-5, rtol=1e-5)
# tests/test_kernels.py's gradient shapes (130 > the reference's 128-row
# tile, so its grid pads), then the placement plane's LoadForecaster fit
# (F = 1, H = 8: 32 gate columns, one warp)
SHAPES = [(8, 5, 5, 40), (64, 5, 5, 40), (33, 7, 3, 16), (1, 1, 2, 8),
          (130, 12, 4, 24), (16, 4, 1, 8)]
# (rows a tile, lanes a piece of dh is split over, steps a chunk): the
# kernel's at 4H = 160 and T <= 8 first (32 lanes where they hold wh in
# registers, 4 otherwise)
TILINGS = [(2, 32, 8), (2, 4, 8), (1, 4, 8), (3, 2, 3), (7, 1, 1), (5, 8, 5)]


@functools.lru_cache(maxsize=None)
def _case(B, T, F, H):
    """numpy inputs, the Pallas kernels' residuals and backward from them,
    and jax.grad through the scan with the cotangent dh of the final h."""
    rng = np.random.default_rng(B * 1000 + T * 100 + F * 10 + H)
    x = rng.normal(size=(B, T, F)).astype(np.float32)
    wx = (rng.normal(size=(F, 4 * H)) * 0.2).astype(np.float32)
    wh = (rng.normal(size=(H, 4 * H)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(4 * H,)) * 0.2).astype(np.float32)
    dh = rng.normal(size=(B, H)).astype(np.float32)
    dc = rng.normal(size=(B, H)).astype(np.float32)
    res = [np.array(r) for r in jax_fwd_train(x, wx, wh, b, interpret=True)]
    pallas_bwd = [np.array(g) for g in jax_bwd(x, *res, wx, wh, dh, dc,
                                               interpret=True)]
    scan_grad = [np.array(g) for g in jax.grad(
        lambda *a: jnp.sum(jax_scan(*a) * dh), argnums=(0, 1, 2, 3))(
            x, wx, wh, b)]
    return (x, wx, wh, b, dh, dc), res, pallas_bwd, scan_grad


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B,T,F,H", SHAPES)
def test_tiled_fwd_train_matches_plain_and_pallas(B, T, F, H):
    (x, wx, wh, b, _, _), res, _, _ = _case(B, T, F, H)
    got = ref.lstm_sequence_fwd_train_tiled_ref(*_torch(x, wx, wh, b))
    plain = ref.lstm_sequence_fwd_train_ref(*_torch(x, wx, wh, b))
    for name, g, p, w in zip(("gates", "c_seq", "h_seq"), got, plain, res):
        assert g.dtype == torch.float32 and g.shape == p.shape
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)
        np.testing.assert_allclose(g.numpy(), p.numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize("rows,lanes,chunk", TILINGS)
@pytest.mark.parametrize("B,T,F,H", SHAPES)
def test_tiled_bwd_matches_plain_pallas_and_jax_grad(B, T, F, H, rows, lanes,
                                                     chunk):
    """From the Pallas residuals and random dh, dc: against the plain
    backward and the Pallas backward.  From the tiled forward's residuals
    and dc = 0: against jax.grad of the reference's scan."""
    (x, wx, wh, b, dh, dc), res, pallas_bwd, scan_grad = _case(B, T, F, H)
    tiling = dict(rows=rows, lanes=lanes, chunk=chunk)
    got = ref.lstm_sequence_bwd_tiled_ref(
        *_torch(x, *res, wx, wh, dh, dc), **tiling)
    plain = ref.lstm_sequence_bwd_ref(*_torch(x, *res, wx, wh, dh, dc))
    names = ("dx", "dwx", "dwh", "db")
    for name, g, p, w in zip(names, got, plain, pallas_bwd):
        assert g.dtype == torch.float32 and g.shape == p.shape
        np.testing.assert_allclose(g.numpy(), p.numpy(), err_msg=name, **TOL)
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)

    xt, wxt, wht, bt, dht = _torch(x, wx, wh, b, dh)
    residuals = ref.lstm_sequence_fwd_train_tiled_ref(xt, wxt, wht, bt)
    got = ref.lstm_sequence_bwd_tiled_ref(
        xt, *residuals, wxt, wht, dht, torch.zeros_like(dht), **tiling)
    for name, g, w in zip(names, got, scan_grad):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)


def test_tiled_bwd_rejects_a_lane_split_that_does_not_divide_4h():
    (x, wx, wh, b, dh, dc), res, _, _ = _case(33, 7, 3, 16)
    args = _torch(x, *res, wx, wh, dh, dc)
    for lanes in (3, 128):
        with pytest.raises(ValueError, match="lanes"):
            ref.lstm_sequence_bwd_tiled_ref(*args, lanes=lanes)
