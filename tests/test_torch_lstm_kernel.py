"""The fused LSTM sequence kernel's plain version against the reference's
Pallas kernel (interpret mode) and its oracle, on the same numpy inputs.

The CUDA kernel itself runs only on a card, and the card's machine has no JAX
for this suite: ``chip_smoke.py`` holds the kernel to the plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lstm_cell.kernel import lstm_sequence_fused as jax_fused
from repro.kernels.lstm_cell.ref import lstm_sequence_ref as jax_ref
from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
from repro_torch.kernels.lstm_cell import ops
from repro_torch.kernels.lstm_cell.ref import lstm_sequence_ref


def _inputs(B, T, F, H, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((B, T, F)).astype(np.float32)
    wx = (rng.normal(size=(F, 4 * H)) * F**-0.5).astype(np.float32)
    wh = (rng.normal(size=(H, 4 * H)) * H**-0.5).astype(np.float32)
    b = (rng.normal(size=(4 * H,)) * 0.1).astype(np.float32)
    return x, wx, wh, b


@pytest.mark.parametrize("H", [8, 40])
@pytest.mark.parametrize("F", [1, 5])
@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("B", [1, 7, 130, 250])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_pallas_kernel_and_oracle(dtype, B, T, F, H):
    """f32: atol 1e-5 on h and c.  bf16 x: atol 2e-2 — the inputs and the
    final state round to bf16, and the JAX oracle also rounds its carry to
    bf16 every step where the fused kernels keep it in f32."""
    x, wx, wh, b = _inputs(B, T, F, H, seed=B * 1000 + T * 100 + F * 10 + H)
    atol = 1e-5 if dtype == "float32" else 2e-2
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    h, c = lstm_sequence_ref(xt, *map(torch.from_numpy, (wx, wh, b)),
                             return_state=True)
    assert h.dtype == c.dtype == xt.dtype and h.shape == c.shape == (B, H)
    for hj, cj in (jax_fused(xj, wx, wh, b, interpret=True),
                   jax_ref(xj, wx, wh, b, return_state=True)):
        np.testing.assert_allclose(h.float().numpy(),
                                   np.asarray(hj, np.float32), rtol=0,
                                   atol=atol)
        np.testing.assert_allclose(c.float().numpy(),
                                   np.asarray(cj, np.float32), rtol=0,
                                   atol=atol)


def test_cpu_dispatch_takes_plain_version_and_launches_nothing():
    x, wx, wh, b = map(torch.from_numpy, _inputs(13, 5, 5, 40))
    before = lstm_kernel.lstm_sequence_fused.launches
    h = ops.lstm_sequence(x, wx, wh, b)
    assert lstm_kernel.lstm_sequence_fused.launches == before == 0
    torch.testing.assert_close(h, lstm_sequence_ref(x, wx, wh, b), rtol=0,
                               atol=0)


def test_dispatch_refuses_gradients():
    """A call that needs a gradient goes through the training pair (its
    plain versions on the CPU), never the serving forward, and refuses a
    device it has no kernels for."""
    x, wx, wh, b = map(torch.from_numpy, _inputs(4, 5, 5, 8))
    wx.requires_grad_(True)
    h = ops.lstm_sequence(x, wx, wh, b)
    assert type(h.grad_fn).__name__ == "_LSTMSequenceBackward"
    torch.testing.assert_close(h.detach(), lstm_sequence_ref(x, wx, wh, b),
                               rtol=0, atol=0)
    with torch.no_grad():
        assert ops.lstm_sequence(x, wx, wh, b).grad_fn is None
    with pytest.raises(ValueError, match="unsupported device"):
        ops.lstm_sequence(*(t.detach().to("meta").requires_grad_(True)
                            for t in (x, wx, wh, b)))
    assert lstm_kernel.lstm_sequence_fused.launches == 0


def test_wrapper_rejects_cpu_tensors_and_bad_shapes():
    x, wx, wh, b = map(torch.from_numpy, _inputs(4, 5, 5, 8))
    with pytest.raises(ValueError, match="one CUDA device"):
        lstm_kernel.lstm_sequence_fused(x, wx, wh, b)
    with pytest.raises(ValueError, match="do not match"):
        lstm_kernel.lstm_sequence_fused(x, wx[:, :-1], wh, b)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        lstm_kernel.lstm_sequence_fused(x.double(), wx, wh, b)
    assert lstm_kernel.lstm_sequence_fused.launches == 0
