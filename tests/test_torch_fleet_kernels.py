"""The stream axis of kernels #1-#4: their plain versions with a leading S
against the reference's Pallas kernels batched by ``jax.vmap`` (interpret
mode), which is what the reference's fleet runs, and the gradients through
``ops.lstm_sequence`` against ``jax.vmap(jax.grad(...))`` through the
reference's op.  The single-stream tests' tolerances: the LSTM forward
atol 1e-5 (bf16 x 2e-2), the training pair and the gradients atol = rtol
= 2e-5, #4 atol = rtol = 1e-5 at K <= 40 (bf16 x: one bf16 step).

The CUDA kernels run only on the card (``chip_smoke.py``'s fleet kernel
phase holds them to these plain versions there, at S = 1, 3 and 8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.int8_matmul.kernel import int8_matmul as jax_int8_matmul
from repro.kernels.lstm_cell import ops as jax_ops
from repro.kernels.lstm_cell.kernel import lstm_sequence_bwd as jax_bwd
from repro.kernels.lstm_cell.kernel import lstm_sequence_fused as jax_fused
from repro.kernels.lstm_cell.kernel import (
    lstm_sequence_fwd_train as jax_fwd_train,
)
from repro.serving import quantize as quantize_ref
from repro_torch.kernels.int8_matmul import kernel as int8_kernel
from repro_torch.kernels.int8_matmul.ops import qmatmul
from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref
from repro_torch.kernels.lstm_cell import kernel as lstm_kernel
from repro_torch.kernels.lstm_cell import ops
from repro_torch.kernels.lstm_cell.ref import (
    lstm_sequence_bwd_ref,
    lstm_sequence_fwd_train_ref,
    lstm_sequence_ref,
)
from repro_torch.serving import quantize

TOL = dict(atol=2e-5, rtol=2e-5)
# (S, B, T, F, H): one and three streams, H = 40 (the paper's) and 10 (not a
# multiple of 4), B = 64 (a speed-fit step) and ragged 37
CASES = [(1, 64, 5, 5, 40), (3, 64, 5, 5, 40), (3, 37, 5, 5, 10),
         (1, 37, 7, 3, 10)]


def _inputs(S, B, T, F, H, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(S, B, T, F)).astype(np.float32)
    wx = (rng.normal(size=(S, F, 4 * H)) * 0.2).astype(np.float32)
    wh = (rng.normal(size=(S, H, 4 * H)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(S, 4 * H)) * 0.2).astype(np.float32)
    dh = rng.normal(size=(S, B, H)).astype(np.float32)
    dc = rng.normal(size=(S, B, H)).astype(np.float32)
    return x, wx, wh, b, dh, dc


def _seed(*shape):
    return int(sum(v * 10**i for i, v in enumerate(shape)))


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """On CPU tensors no kernel launches."""
    yield
    for w in (lstm_kernel.lstm_sequence_fused,
              lstm_kernel.lstm_sequence_fwd_train,
              lstm_kernel.lstm_sequence_bwd, int8_kernel.int8_matmul):
        assert w.launches == 0


@pytest.mark.parametrize("S,B,T,F,H", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_serving_forward_matches_vmapped_pallas(dtype, S, B, T, F, H):
    x, wx, wh, b, _, _ = _inputs(S, B, T, F, H, _seed(S, B, T, F, H))
    atol = 1e-5 if dtype == "float32" else 2e-2
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    hj, cj = jax.vmap(lambda *a: jax_fused(*a, interpret=True))(
        xj, wx, wh, b)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    h, c = lstm_sequence_ref(xt, *map(torch.from_numpy, (wx, wh, b)),
                             return_state=True)
    assert h.shape == c.shape == (S, B, H) and h.dtype == xt.dtype
    for got, want in ((h, hj), (c, cj)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=0,
                                   atol=atol)
    with torch.inference_mode():
        h_op = ops.lstm_sequence(xt, *map(torch.from_numpy, (wx, wh, b)))
    assert torch.equal(h_op, h)


@pytest.mark.parametrize("S,B,T,F,H", CASES)
def test_plain_training_pair_matches_vmapped_pallas(S, B, T, F, H):
    """The residuals, then the backward from the reference's residuals and
    the same random cotangents: every stream's dx and its own dwx, dwh,
    db."""
    x, wx, wh, b, dh, dc = _inputs(S, B, T, F, H, _seed(S, B, T, F, H))
    res = jax.vmap(lambda *a: jax_fwd_train(*a, interpret=True))(
        x, wx, wh, b)
    got = lstm_sequence_fwd_train_ref(*map(torch.from_numpy,
                                           (x, wx, wh, b)))
    for g, w in zip(got, res):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    res = [np.array(r) for r in res]
    want = jax.vmap(lambda *a: jax_bwd(*a, interpret=True))(
        x, *res, wx, wh, dh, dc)
    grads = lstm_sequence_bwd_ref(*map(torch.from_numpy,
                                       (x, *res, wx, wh, dh, dc)))
    for name, g, w, shape in zip(
            ("dx", "dwx", "dwh", "db"), grads, want,
            ((S, B, T, F), (S, F, 4 * H), (S, H, 4 * H), (S, 4 * H))):
        assert tuple(g.shape) == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("S,B,T,F,H", CASES)
def test_stream_axis_gradient_matches_vmapped_jax_grad(S, B, T, F, H):
    """``_LSTMSequence`` over a stream axis: the gradient of the sum over
    streams of each stream's h against a random cotangent equals
    ``jax.vmap(jax.grad(...))`` of the reference's op (its custom VJP over
    the Pallas kernels), per stream, and equals each stream's
    single-stream gradient exactly."""
    x, wx, wh, b, ct, _ = _inputs(S, B, T, F, H, _seed(S, B, T, F, H) + 1)
    want = jax.vmap(jax.grad(
        lambda x, wx, wh, b, ct: jnp.sum(
            jax_ops.lstm_sequence(x, wx, wh, b, interpret=True) * ct),
        argnums=(0, 1, 2, 3)))(x, wx, wh, b, ct)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, wx, wh, b)]
    h = ops.lstm_sequence(*leaves)
    assert tuple(h.shape) == (S, B, H)
    got = torch.autograd.grad(h, leaves, grad_outputs=torch.from_numpy(ct))
    for name, g, w in zip(("dx", "dwx", "dwh", "db"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)
    for s in range(S):
        one = [torch.from_numpy(a[s]).requires_grad_(True)
               for a in (x, wx, wh, b)]
        g1 = torch.autograd.grad(ops.lstm_sequence(*one), one,
                                 grad_outputs=torch.from_numpy(ct[s]))
        for g, w in zip(got, g1):
            assert torch.equal(g[s], w)


def test_stream_axis_bf16_input_gradient_comes_back_in_bf16():
    x, wx, wh, b, ct, _ = map(torch.from_numpy, _inputs(2, 8, 5, 5, 8, 3))
    x = x.to(torch.bfloat16).requires_grad_(True)
    wh.requires_grad_(True)
    h = ops.lstm_sequence(x, wx, wh, b)
    assert h.dtype == torch.bfloat16 and h.shape == (2, 8, 8)
    dx, dwh = torch.autograd.grad(h, [x, wh],
                                  grad_outputs=ct.to(torch.bfloat16))
    assert dx.dtype == torch.bfloat16 and dx.shape == x.shape
    assert dwh.dtype == torch.float32 and dwh.shape == (2, 8, 32)


# (S, M, K, N): the int8 fleet predict's three products and a ragged edge
INT8_CASES = [(1, 1280, 5, 160), (3, 256, 40, 160), (3, 256, 40, 10),
              (3, 33, 40, 17)]


@pytest.mark.parametrize("S,M,K,N", INT8_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_int8_matmul_matches_vmapped_pallas(dtype, S, M, K, N):
    rng = np.random.default_rng(S + M + K + N)
    x = rng.normal(size=(S, M, K)).astype(np.float32)
    q = rng.integers(-127, 128, size=(S, K, N)).astype(np.int8)
    s = (np.abs(rng.normal(size=(S, N))) * 0.01).astype(np.float32)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = jax.vmap(lambda a, b, c: jax_int8_matmul(a, b, c,
                                                    interpret=True))(
        xj, jnp.asarray(q), jnp.asarray(s))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = int8_matmul_ref(xt, torch.from_numpy(q), torch.from_numpy(s))
    assert got.shape == (S, M, N) and got.dtype == xt.dtype
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_less(np.abs(got - want),
                                     2.0**-7 * np.abs(want) + 1e-5)


def test_stacked_qmatmul_matches_vmapped_reference():
    """``qmatmul`` of a stacked ``QTensor`` (x (S, B, T, K)) against the
    reference's ``qmatmul`` under ``jax.vmap``, each stream's weight
    quantized on its own."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 4, 5, 40)).astype(np.float32)
    w = rng.normal(size=(3, 40, 160)).astype(np.float32)
    qts = [quantize.quantize(torch.from_numpy(w[s])) for s in range(3)]
    stacked = quantize.QTensor(q=torch.stack([t.q for t in qts]),
                               scale=torch.stack([t.scale for t in qts]),
                               orig_dtype="float32")
    got = qmatmul(torch.from_numpy(x), stacked)
    refs = [quantize_ref.quantize(jnp.asarray(w[s])) for s in range(3)]
    want = jax.vmap(lambda a, q, sc: jax_ops_qmatmul(a, q, sc))(
        jnp.asarray(x), jnp.stack([r.q for r in refs]),
        jnp.stack([r.scale for r in refs]))
    assert got.shape == (3, 4, 5, 160)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def jax_ops_qmatmul(x, q, scale):
    from repro.kernels.int8_matmul.ops import qmatmul as ref_qmatmul

    return ref_qmatmul(x, quantize_ref.QTensor(q=q, scale=scale,
                                               orig_dtype="float32"),
                       interpret=True)


@pytest.mark.parametrize("S,B", [(0, 8), (2, 0)])
def test_empty_fleet_or_batch_gives_empty_outputs(S, B):
    """S = 0 or B = 0: the plain versions give outputs of the stream-axis
    shapes (zero weight gradients at B = 0), and nothing launches."""
    x, wx, wh, b, dh, dc = map(torch.from_numpy, _inputs(max(S, 1), max(B, 1),
                                                         5, 5, 8, 9))
    x, dh, dc = x[:S, :B], dh[:S, :B], dc[:S, :B]
    wx, wh, b = wx[:S], wh[:S], b[:S]
    h, c = lstm_sequence_ref(x, wx, wh, b, return_state=True)
    assert h.shape == (S, B, 8)
    res = lstm_sequence_fwd_train_ref(x, wx, wh, b)
    assert res[0].shape == (S, B, 5, 32)
    dx, dwx, dwh, db = lstm_sequence_bwd_ref(x, *res, wx, wh, dh, dc)
    assert dx.shape == (S, B, 5, 5) and dwx.shape == (S, 5, 32)
    assert dwh.shape == (S, 8, 32) and db.shape == (S, 32)
    assert not bool(dwx.abs().sum())
    y = int8_matmul_ref(x[..., 0, :].contiguous(),
                        torch.zeros((S, 5, 7), dtype=torch.int8),
                        torch.ones((S, 7)))
    assert y.shape == (S, B, 7)


def test_stream_axis_wrappers_check_shapes_before_the_device():
    """The wrappers refuse mismatched stacked shapes and CPU tensors."""
    x, wx, wh, b, dh, dc = map(torch.from_numpy, _inputs(2, 4, 5, 5, 8, 1))
    with pytest.raises(ValueError, match="do not match S=2"):
        lstm_kernel.lstm_sequence_fused(x, wx[:1], wh, b)
    with pytest.raises(ValueError, match="one CUDA device"):
        lstm_kernel.lstm_sequence_fwd_train(x, wx, wh, b)
    with pytest.raises(ValueError, match="with a stream axis"):
        lstm_kernel.lstm_sequence_fused(x[0, 0], wx, wh, b)
    res = lstm_sequence_fwd_train_ref(x, wx, wh, b)
    with pytest.raises(ValueError, match="expected"):
        lstm_kernel.lstm_sequence_bwd(x, *res, wx, wh, dh[:, :2], dc)
    q = torch.zeros((2, 5, 7), dtype=torch.int8)
    with pytest.raises(ValueError, match="do not match"):
        int8_kernel.int8_matmul(x[:, :, 0], q, torch.ones((1, 7)))
    with pytest.raises(ValueError, match="one CUDA device"):
        int8_kernel.int8_matmul(x[:, :, 0].contiguous(), q,
                                torch.ones((2, 7)))
