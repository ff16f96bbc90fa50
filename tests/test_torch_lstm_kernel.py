"""The fused LSTM sequence kernel's plain version against the reference's
Pallas kernel (interpret mode) and its oracle, on the same numpy inputs;
and the serving kernel's Hopper algorithm (``ref.lstm_sequence_tiled_ref``,
the training kernel's order of summation) against the Pallas kernel.

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
from repro_torch.kernels.lstm_cell.ref import (
    lstm_sequence_ref,
    lstm_sequence_tiled_ref,
)


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


@pytest.mark.parametrize("B,T,F,H", [(8, 5, 5, 40), (33, 7, 3, 16)])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_plain_version_with_bf16_weights_matches_pallas_kernel(x_dtype, B, T,
                                                               F, H):
    """bf16 wx, wh and b, as the reference's sweep passes them: both sides
    cast them to f32 (exact), so the bf16 weights change nothing but their
    values.  atol 2e-2, as the bf16 cases above."""
    x, *w = _inputs(B, T, F, H, seed=B + T + F + H)
    xj = jnp.asarray(x).astype(getattr(jnp, x_dtype))
    xt = torch.from_numpy(x).to(getattr(torch, x_dtype))
    wt = [torch.from_numpy(a).bfloat16() for a in w]
    h, c = lstm_sequence_ref(xt, *wt, return_state=True)
    hj, cj = jax_fused(xj, *(jnp.asarray(a).astype(jnp.bfloat16) for a in w),
                       interpret=True)
    for got, want in ((h, hj), (c, cj)):
        assert got.dtype == xt.dtype
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=0,
                                   atol=2e-2)


@pytest.mark.parametrize("B,T,F,H", [(250, 5, 5, 40), (4, 5, 5, 117),
                                     (7, 5, 3, 10), (9, 12, 5, 72),
                                     (3, 4, 449, 30)])
@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_serving_algorithm_matches_pallas_kernel(x_dtype, w_dtype, B, T, F,
                                                 H):
    """The serving kernel's order of summation (the input projection first,
    h.wh in four interleaved partial sums) against the Pallas
    ``lstm_sequence_fused`` in interpret mode: the paper's shape, the
    largest H the kernel takes at F = 5 (117, wh from shared memory), H not
    a multiple of 4, H over 64 with two chunks of steps, and a wide F (x
    read from global memory on the card).  Float32 outputs within 1e-5; bf16
    outputs, each side's float32 result rounded once, within one bf16 step
    (2^-7 of the value) and 1e-5, as ``chip_smoke.py`` holds the kernel."""
    x, *w = _inputs(B, T, F, H, seed=7 * B + T + F + H)
    xt = torch.from_numpy(x).to(getattr(torch, x_dtype))
    wt = [torch.from_numpy(a).to(getattr(torch, w_dtype)) for a in w]
    h, c = lstm_sequence_tiled_ref(xt, *wt)
    hj, cj = jax_fused(jnp.asarray(x).astype(getattr(jnp, x_dtype)),
                       *(jnp.asarray(a).astype(getattr(jnp, w_dtype))
                         for a in w), interpret=True)
    for got, want in ((h, hj), (c, cj)):
        assert got.dtype == xt.dtype and got.shape == (B, H)
        got = got.float().numpy()
        want = np.asarray(want, np.float32)
        rtol = 0.0 if x_dtype == "float32" else 2.0**-7
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5)


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
    # on meta (the dry run's trace) the training pair's meta operators
    # stand in: the kernels' shapes, no launch
    h = ops.lstm_sequence(*(t.detach().to("meta").requires_grad_(True)
                            for t in (x, wx, wh, b)))
    assert h.device.type == "meta" and h.shape == (4, 8)
    assert type(h.grad_fn).__name__ == "_LSTMSequenceBackward"
    assert lstm_kernel.lstm_sequence_fused.launches == 0


def test_wrapper_rejects_cpu_tensors_and_bad_shapes():
    x, wx, wh, b = map(torch.from_numpy, _inputs(4, 5, 5, 8))
    with pytest.raises(ValueError, match="one CUDA device"):
        lstm_kernel.lstm_sequence_fused(x, wx, wh, b)
    with pytest.raises(ValueError, match="do not match"):
        lstm_kernel.lstm_sequence_fused(x, wx[:, :-1], wh, b)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        lstm_kernel.lstm_sequence_fused(x.double(), wx, wh, b)
    # bf16 weights are taken, as the reference's kernels take them: these
    # CPU tensors get past the type checks to the placement check
    bf16 = [w.bfloat16() for w in (wx, wh, b)]
    for wrapper in (lstm_kernel.lstm_sequence_fused,
                    lstm_kernel.lstm_sequence_fwd_train):
        with pytest.raises(ValueError, match="one CUDA device"):
            wrapper(x, *bf16)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            wrapper(x, wx.double(), wh, b)
    assert lstm_kernel.lstm_sequence_fused.launches == 0
