"""The one-step LSTM kernel's plain version and the per-step scan against the
reference's Pallas ``lstm_cell`` (interpret mode), its oracle and its
``lstm_sequence_scan``, on the same numpy inputs; the dispatch, the
refusals and the wrapper's checks.

The CUDA kernel itself runs only on a card, and the card's machine has no JAX
for this suite: ``chip_smoke.py`` holds the kernel to the plain version there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lstm_cell.kernel import lstm_cell as jax_cell
from repro.kernels.lstm_cell.ops import lstm_sequence as jax_sequence
from repro.kernels.lstm_cell.ops import lstm_sequence_scan as jax_scan
from repro.kernels.lstm_cell.ref import lstm_cell_ref as jax_cell_ref
from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
from repro_torch.kernels.lstm_cell import ops, ref

# the reference's float32 tolerance (tests/test_kernels.py: tol)
ATOL = 2e-5


def _normal(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _cell_inputs(B, F, H, seed):
    """x, h, c normal and the weights 0.2 normal, as the reference's
    ``test_lstm_cell_sweep`` draws them."""
    rng = np.random.default_rng(seed)
    return (_normal(rng, (B, F)), _normal(rng, (B, H)), _normal(rng, (B, H)),
            _normal(rng, (F, 4 * H), 0.2), _normal(rng, (H, 4 * H), 0.2),
            _normal(rng, (4 * H,), 0.2))


def _seq_inputs(B, T, F, H, seed):
    rng = np.random.default_rng(seed)
    return (_normal(rng, (B, T, F)), _normal(rng, (F, 4 * H), 0.2),
            _normal(rng, (H, 4 * H), 0.2), _normal(rng, (4 * H,), 0.2))


def _both(arrays, dtypes):
    """The same arrays as JAX and torch tensors of the named dtypes."""
    return ([jnp.asarray(a).astype(getattr(jnp, d))
             for a, d in zip(arrays, dtypes)],
            [torch.from_numpy(a).to(getattr(torch, d))
             for a, d in zip(arrays, dtypes)])


def _assert_close(got: torch.Tensor, want, dtype: str):
    """float32: within ATOL.  bfloat16: within one bf16 step of the value
    (2^-7 |want|): both sides compute in float32 and round once, so they may
    straddle a rounding boundary."""
    want = np.asarray(want, np.float32)
    assert str(got.dtype) == f"torch.{dtype}"
    d = np.abs(got.float().numpy() - want)
    limit = ATOL + (2.0**-7 * np.abs(want) if dtype == "bfloat16" else 0.0)
    assert (d <= limit).all(), float(d.max())


@pytest.mark.parametrize("B,F,H", [(4, 5, 40), (128, 5, 40), (33, 7, 16),
                                   (1, 1, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_cell_matches_pallas_kernel_and_oracle(dtype, B, F, H):
    """The reference's sweep shapes, every input in ``dtype`` as there."""
    jx, tx = _both(_cell_inputs(B, F, H, seed=B + F + H), [dtype] * 6)
    h, c = ref.lstm_cell_ref(*tx)
    for hj, cj in (jax_cell(*jx, interpret=True, block_b=32),
                   jax_cell_ref(*jx)):
        _assert_close(h, hj, str(hj.dtype))
        _assert_close(c, cj, str(cj.dtype))


def test_plain_cell_keeps_each_state_dtype():
    """bf16 h with float32 c (and float32 x and weights): h' comes back in
    bf16 and c' in float32, as the reference's kernel returns them."""
    dtypes = ["float32", "bfloat16", "float32", "float32", "float32",
              "float32"]
    jx, tx = _both(_cell_inputs(33, 5, 40, seed=7), dtypes)
    h, c = ref.lstm_cell_ref(*tx)
    assert (h.dtype, c.dtype) == (torch.bfloat16, torch.float32)
    for hj, cj in (jax_cell(*jx, interpret=True, block_b=32),
                   jax_cell_ref(*jx)):
        assert (hj.dtype, cj.dtype) == (jnp.bfloat16, jnp.float32)
        _assert_close(h, hj, "bfloat16")
        _assert_close(c, cj, "float32")


@pytest.mark.parametrize("B,T,F,H", [(8, 5, 5, 40), (33, 7, 3, 16),
                                     (1, 1, 2, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_matches_reference_scan(dtype, B, T, F, H):
    """``ops.lstm_sequence_scan`` on the CPU against the reference's, whose
    h/c carry is in x's dtype.  In bf16 the fused kernels' float32 carry is
    not within the tolerance of it where there is a carry (T > 1), so the
    comparison tells the two carries apart."""
    arrays = _seq_inputs(B, T, F, H, seed=B * T + F + H)
    jx, tx = _both(arrays, [dtype, "float32", "float32", "float32"])
    want = jax_scan(*jx, interpret=True)
    h = ops.lstm_sequence_scan(*tx)
    _assert_close(h, want, dtype)
    if dtype == "bfloat16" and T > 1:
        with pytest.raises(AssertionError):
            _assert_close(ref.lstm_sequence_ref(*tx), want, dtype)
    if dtype == "float32":  # the fused path, the reference's own tolerance
        torch.testing.assert_close(h, ops.lstm_sequence(*tx), rtol=0,
                                   atol=ATOL)


def test_scan_without_steps_or_rows():
    """T = 0 gives the zero state, as the reference's scan over no steps;
    B = 0 gives no rows."""
    wx, wh, b = map(torch.from_numpy, _seq_inputs(1, 1, 3, 8, seed=0)[1:])
    h = ops.lstm_sequence_scan(torch.zeros((4, 0, 3)), wx, wh, b)
    want = jax_scan(jnp.zeros((4, 0, 3)), *(w.numpy() for w in (wx, wh, b)),
                    interpret=True)
    assert h.shape == (4, 8) and not h.any() and not np.asarray(want).any()
    assert ops.lstm_sequence_scan(torch.zeros((0, 5, 3)), wx, wh, b).shape \
        == (0, 8)


def test_cpu_dispatch_takes_plain_versions_and_launches_nothing():
    _, tx = _both(_cell_inputs(13, 5, 40, seed=1), ["float32"] * 6)
    x, wx, wh, b = map(torch.from_numpy, _seq_inputs(13, 5, 5, 40, seed=2))
    step = ops.lstm_step(*tx)
    h = ops.lstm_sequence_scan(x, wx, wh, b)
    assert lstm_kernel.lstm_cell.launches == 0
    assert lstm_kernel.lstm_sequence_fused.launches == 0
    for got, want in zip(step, ref.lstm_cell_ref(*tx)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(h, ref.lstm_sequence_scan_ref(x, wx, wh, b),
                               rtol=0, atol=0)


def test_step_and_scan_refuse_gradients():
    """Forward-only on every device: the CPU hands out no gradient the card
    lacks.  Without grad mode the same calls run."""
    _, tx = _both(_cell_inputs(4, 5, 8, seed=3), ["float32"] * 6)
    x, wx, wh, b = map(torch.from_numpy, _seq_inputs(4, 5, 5, 8, seed=4))
    for i in range(6):
        args = [t.clone().requires_grad_(j == i) for j, t in enumerate(tx)]
        with pytest.raises(RuntimeError, match="forward-only"):
            ops.lstm_step(*args)
        with torch.no_grad():
            ops.lstm_step(*args)
    for i in range(4):
        args = [t.clone().requires_grad_(j == i)
                for j, t in enumerate((x, wx, wh, b))]
        with pytest.raises(RuntimeError, match="forward-only"):
            ops.lstm_sequence_scan(*args)
        with torch.no_grad():
            ops.lstm_sequence_scan(*args)
    # on meta (the dry run's trace) the cell's meta operator stands in
    # for each step: the kernel's shapes, no launch
    with torch.no_grad():
        h = ops.lstm_sequence_scan(*(t.to("meta") for t in (x, wx, wh, b)))
    assert h.device.type == "meta" and h.shape == (4, 8)
    assert lstm_kernel.lstm_cell.launches == 0


def test_wrapper_rejects_cpu_tensors_bad_shapes_and_float64():
    _, (x, h, c, wx, wh, b) = _both(_cell_inputs(4, 5, 8, seed=5),
                                    ["float32"] * 6)
    with pytest.raises(ValueError, match="one CUDA device"):
        lstm_kernel.lstm_cell(x, h, c, wx, wh, b)
    with pytest.raises(ValueError, match="one CUDA device"):  # bf16 weights
        lstm_kernel.lstm_cell(x, h, c, wx.bfloat16(), wh.bfloat16(),
                              b.bfloat16())
    with pytest.raises(ValueError, match="do not match"):
        lstm_kernel.lstm_cell(x, h[:, :-1], c, wx, wh, b)
    with pytest.raises(ValueError, match="do not match"):
        lstm_kernel.lstm_cell(x, h, c, wx[:, :-1], wh, b)
    with pytest.raises(ValueError, match="expected x"):
        lstm_kernel.lstm_cell(x[None], h, c, wx, wh, b)
    for i in range(6):
        args = [t.double() if j == i else t
                for j, t in enumerate((x, h, c, wx, wh, b))]
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            lstm_kernel.lstm_cell(*args)
    assert lstm_kernel.lstm_cell.launches == 0


def test_wrapper_returns_empty_state_without_launch_at_no_rows(monkeypatch):
    """B = 0: empty (0,H) outputs in h's and c's dtypes and no launch (the
    placement check, which refuses these CPU tensors, is set aside so the
    wrapper's own path is what runs)."""
    monkeypatch.setattr(lstm_kernel, "_check_placement", lambda *a: None)
    monkeypatch.setattr(lstm_kernel, "cell_library", None)  # never reached
    _, (x, h, c, wx, wh, b) = _both(_cell_inputs(0, 5, 8, seed=6),
                                    ["float32"] * 6)
    h1, c1 = lstm_kernel.lstm_cell(x, h.bfloat16(), c, wx, wh, b)
    assert (h1.shape, h1.dtype) == ((0, 8), torch.bfloat16)
    assert (c1.shape, c1.dtype) == ((0, 8), torch.float32)
    assert lstm_kernel.lstm_cell.launches == 0


def test_sequence_gradients_come_back_in_the_weights_dtype():
    """``ops.lstm_sequence`` with bf16 weights: the gradient of each weight
    in bf16, as the reference's VJP returns it (and within one bf16 step of
    it), dx in x's float32."""
    x, wx, wh, b = _seq_inputs(6, 5, 5, 8, seed=9)
    dtypes = ["float32", "bfloat16", "bfloat16", "bfloat16"]
    jx, tx = _both((x, wx, wh, b), dtypes)
    cot = _normal(np.random.default_rng(10), (6, 8))

    def loss(*args):
        return jnp.sum(jax_sequence(*args, interpret=True) * cot)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*jx)
    args = [t.requires_grad_(True) for t in tx]
    (ops.lstm_sequence(*args) * torch.from_numpy(cot)).sum().backward()
    for t, w, d in zip(args, want, dtypes):
        _assert_close(t.grad, w, d)
