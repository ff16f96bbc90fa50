"""The LSTM training pair's plain versions against the reference's Pallas
kernels (interpret mode), and the port's gradient through
``ops.lstm_sequence`` against ``jax.grad`` of the reference's, on the same
numpy inputs.

The CUDA kernels run only on a card, and the card's machine has no JAX for
this suite: ``chip_smoke.py`` holds them to these plain versions there.
Tolerance: atol = rtol = 2e-5, the reference's own for its gradient tests
(``tests/test_kernels.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lstm_cell import ops as jax_ops
from repro.kernels.lstm_cell.kernel import lstm_sequence_bwd as jax_bwd
from repro.kernels.lstm_cell.kernel import (
    lstm_sequence_fwd_train as jax_fwd_train,
)
from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
from repro_torch.kernels.lstm_cell import ops
from repro_torch.kernels.lstm_cell.ref import (
    lstm_sequence_bwd_ref,
    lstm_sequence_fwd_train_ref,
    lstm_sequence_ref,
)

TOL = dict(atol=2e-5, rtol=2e-5)
# tests/test_kernels.py's gradient shapes (130 > the reference's 128-row
# tile, so its grid pads), and the pretrain's step shape
SHAPES = [(8, 5, 5, 40), (64, 5, 5, 40), (33, 7, 3, 16), (1, 1, 2, 8),
          (130, 12, 4, 24), (256, 5, 5, 40)]


def _inputs(B, T, F, H, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, F)).astype(np.float32)
    wx = (rng.normal(size=(F, 4 * H)) * 0.2).astype(np.float32)
    wh = (rng.normal(size=(H, 4 * H)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(4 * H,)) * 0.2).astype(np.float32)
    dh = rng.normal(size=(B, H)).astype(np.float32)
    dc = rng.normal(size=(B, H)).astype(np.float32)
    return x, wx, wh, b, dh, dc


def _seed(B, T, F, H):
    return B * 1000 + T * 100 + F * 10 + H


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """On CPU tensors the training kernels never launch."""
    yield
    assert lstm_kernel.lstm_sequence_fwd_train.launches == 0
    assert lstm_kernel.lstm_sequence_bwd.launches == 0
    assert lstm_kernel.lstm_sequence_fused.launches == 0


@pytest.mark.parametrize("B,T,F,H", SHAPES)
def test_plain_fwd_train_matches_pallas_kernel(B, T, F, H):
    x, wx, wh, b, _, _ = _inputs(B, T, F, H, _seed(B, T, F, H))
    want = jax_fwd_train(x, wx, wh, b, interpret=True)
    got = lstm_sequence_fwd_train_ref(*map(torch.from_numpy, (x, wx, wh, b)))
    for name, g, w, shape in zip(("gates", "c_seq", "h_seq"), got, want,
                                 ((B, T, 4 * H), (B, T, H), (B, T, H))):
        assert tuple(g.shape) == shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("B,T,F,H", SHAPES)
def test_plain_bwd_matches_pallas_kernel(B, T, F, H):
    """Both backwards from the same residuals (the reference's) and the same
    random cotangents of the final (h, c)."""
    x, wx, wh, b, dh, dc = _inputs(B, T, F, H, _seed(B, T, F, H))
    res = [np.array(r) for r in jax_fwd_train(x, wx, wh, b, interpret=True)]
    want = jax_bwd(x, *res, wx, wh, dh, dc, interpret=True)
    got = lstm_sequence_bwd_ref(
        *map(torch.from_numpy, (x, *res, wx, wh, dh, dc)))
    for name, g, w in zip(("dx", "dwx", "dwh", "db"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("B,T,F,H", SHAPES)
def test_op_gradient_matches_jax_grad_and_autograd(B, T, F, H):
    """The gradient through ``ops.lstm_sequence`` on CPU tensors (the
    ``autograd.Function`` with the plain bodies) against ``jax.grad`` of the
    reference's ``lstm_sequence`` (its custom VJP over the Pallas kernels in
    interpret mode) and against torch autograd through ``lstm_sequence_ref``,
    with a random cotangent."""
    x, wx, wh, b, ct, _ = _inputs(B, T, F, H, _seed(B, T, F, H))
    want = jax.grad(
        lambda *a: jnp.sum(jax_ops.lstm_sequence(*a, interpret=True) * ct),
        argnums=(0, 1, 2, 3))(x, wx, wh, b)

    def grads(fn):
        leaves = [torch.from_numpy(a).requires_grad_(True)
                  for a in (x, wx, wh, b)]
        h = fn(*leaves)
        assert tuple(h.shape) == (B, H)
        return torch.autograd.grad(h, leaves, grad_outputs=torch.from_numpy(ct))

    got = grads(ops.lstm_sequence)
    autograd = grads(lstm_sequence_ref)
    for name, g, w, a in zip(("dx", "dwx", "dwh", "db"), got, want, autograd):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)
        np.testing.assert_allclose(g.numpy(), a.numpy(), err_msg=name, **TOL)


def test_op_returns_only_the_gradients_asked_for():
    x, wx, wh, b, ct, _ = map(torch.from_numpy, _inputs(16, 5, 5, 8))
    wh.requires_grad_(True)
    h = ops.lstm_sequence(x, wx, wh, b)
    assert h.grad_fn is not None
    (dwh,) = torch.autograd.grad(h, [wh], grad_outputs=ct)
    assert dwh.shape == wh.shape
    want = lstm_sequence_bwd_ref(
        x, *lstm_sequence_fwd_train_ref(x, wx, wh.detach(), b), wx,
        wh.detach(), ct, torch.zeros_like(ct))[2]
    torch.testing.assert_close(dwh, want, rtol=0, atol=0)


def test_bf16_input_gradient_comes_back_in_bf16():
    x, wx, wh, b, ct, _ = map(torch.from_numpy, _inputs(8, 5, 5, 8))
    x = x.to(torch.bfloat16).requires_grad_(True)
    h = ops.lstm_sequence(x, wx, wh, b)
    assert h.dtype == torch.bfloat16
    (dx,) = torch.autograd.grad(h, [x], grad_outputs=ct.to(torch.bfloat16))
    assert dx.dtype == torch.bfloat16 and dx.shape == x.shape


def test_training_wrappers_reject_cpu_tensors_and_bad_shapes():
    x, wx, wh, b, dh, dc = map(torch.from_numpy, _inputs(4, 5, 5, 8))
    res = lstm_sequence_fwd_train_ref(x, wx, wh, b)
    with pytest.raises(ValueError, match="one CUDA device"):
        lstm_kernel.lstm_sequence_fwd_train(x, wx, wh, b)
    with pytest.raises(ValueError, match="do not match"):
        lstm_kernel.lstm_sequence_fwd_train(x, wx[:, :-1], wh, b)
    with pytest.raises(ValueError, match="one CUDA device"):
        lstm_kernel.lstm_sequence_bwd(x, *res, wx, wh, dh, dc)
    with pytest.raises(ValueError, match="gates is"):
        lstm_kernel.lstm_sequence_bwd(x, res[0][:, :-1], *res[1:], wx, wh,
                                      dh, dc)
    with pytest.raises(TypeError, match="dh must be float32"):
        lstm_kernel.lstm_sequence_bwd(x, *res, wx, wh, dh.double(), dc)
