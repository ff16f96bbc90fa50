"""The Mamba2 selective scan of the port on the CPU, held to the JAX package.

The port's plain versions (``kernels/ssm_scan/ref.py``) are what the CUDA
kernel is held to on the card (``chip_smoke.py``), so here they are held to
the reference: to the Pallas kernel in interpret mode from a zero state at
``tests/test_kernels.py::test_ssm_scan_sweep``'s shapes and tolerance, to
the reference's oracle ``ssm_scan_ref`` from a nonzero state, and, in the
model layout, ``ops.selective_scan`` to the reference's ``selective_scan``
in interpret mode.  Inputs come from numpy seeds and go to both, drawn with
the reference test's laws.  The wrapper refuses what the kernel does not
take; a CUDA launch cannot run here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.kernel import ssm_scan as pallas_scan
from repro.kernels.ssm_scan.ops import selective_scan as selective_scan_jax
from repro.kernels.ssm_scan.ref import ssm_scan_ref as oracle_jax
from repro.models import ssm as ssm_ref
from repro_torch.kernels.ssm_scan import kernel, ops, ref
from repro_torch.models import ssm

# the reference's tolerance (tests/test_kernels.py), atol = rtol
TOL = 1e-4
# (BH, T, P, N, chunk) of tests/test_kernels.py::test_ssm_scan_sweep
SWEEP = [(4, 64, 16, 16, 32), (2, 90, 32, 16, 32), (1, 33, 8, 8, 16)]


def _softplus(v):
    return np.log1p(np.exp(-np.abs(v))) + np.maximum(v, 0)


def _flat(seed, BH, T, P, N, dt_scale=1.0):
    """x normal (BH,T,P), b and c 0.3 normal (BH,T,N), dt softplus(normal)
    (BH,T) times ``dt_scale``, a = -exp(normal) and d normal (BH,), float32
    numpy: the reference test's laws."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BH, T, P))
    b, c = (rng.standard_normal((BH, T, N)) * 0.3 for _ in range(2))
    dt = _softplus(rng.standard_normal((BH, T))) * dt_scale
    a = -np.exp(rng.standard_normal(BH))
    d = rng.standard_normal(BH)
    return [v.astype(np.float32) for v in (x, b, c, dt, a, d)]


def _model(seed, B, T, H, P, N, dt_scale=1.0):
    """The same laws in the model layout: x (B,T,H,P), b, c (B,T,N), dt
    (B,T,H), a, d (H,)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P))
    b, c = (rng.standard_normal((B, T, N)) * 0.3 for _ in range(2))
    dt = _softplus(rng.standard_normal((B, T, H))) * dt_scale
    a = -np.exp(rng.standard_normal(H))
    d = rng.standard_normal(H)
    return [v.astype(np.float32) for v in (x, b, c, dt, a, d)]


def _state(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def _broadcast_heads(x, b, c, dt, a, d, state0=None):
    """The model layout as the reference's flat layout: row (b, h), b and c
    repeated per head, as ``selective_scan`` of the reference does."""
    B, T, H, P = x.shape
    N = b.shape[-1]
    flat = [x.transpose(0, 2, 1, 3).reshape(B * H, T, P),
            np.broadcast_to(b[:, None], (B, H, T, N)).reshape(B * H, T, N),
            np.broadcast_to(c[:, None], (B, H, T, N)).reshape(B * H, T, N),
            dt.transpose(0, 2, 1).reshape(B * H, T),
            np.broadcast_to(a, (B, H)).reshape(B * H),
            np.broadcast_to(d, (B, H)).reshape(B * H)]
    if state0 is not None:
        flat.append(state0.reshape(B * H, P, N))
    return [jnp.asarray(np.ascontiguousarray(v)) for v in flat]


@pytest.mark.parametrize("BH,T,P,N,chunk", SWEEP)
def test_plain_version_matches_pallas_kernel(BH, T, P, N, chunk):
    arrays = _flat(BH * 1000 + T, BH, T, P, N)
    y_want, s_want = pallas_scan(*map(jnp.asarray, arrays), chunk=chunk,
                                 interpret=True)
    y, s = ref.ssm_scan_ref(*map(torch.tensor, arrays))
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    assert s.shape == (BH, P, N)
    _close(y, y_want)
    _close(s, s_want)


@pytest.mark.parametrize("BH,T,P,N", [(4, 64, 16, 16), (3, 17, 8, 8),
                                      (2, 33, 64, 64)])
def test_plain_version_matches_oracle_from_a_state(BH, T, P, N):
    arrays = _flat(T, BH, T, P, N)
    s0 = _state(T + 1, BH, P, N)
    y_want, s_want = oracle_jax(*map(jnp.asarray, arrays), jnp.asarray(s0))
    y, s = ref.ssm_scan_ref(*map(torch.tensor, arrays), torch.tensor(s0))
    _close(y, y_want)
    _close(s, s_want)


def test_selective_scan_matches_reference_ops():
    """``ops.selective_scan`` (the model layout, b and c shared by the
    heads) from a zero state, against the reference's ``selective_scan``
    in interpret mode."""
    B, T, H, P, N = 2, 40, 3, 16, 8
    arrays = _model(7, B, T, H, P, N)
    y_want, s_want = selective_scan_jax(*map(jnp.asarray, arrays), chunk=16,
                                        interpret=True)
    y, s = ops.selective_scan(*map(torch.tensor, arrays))
    assert y.shape == (B, T, H, P) and s.shape == (B, H, P, N)
    _close(y, y_want)
    _close(s, s_want)


def test_selective_scan_carries_a_state_in_two_pieces():
    """A state given to ``ops.selective_scan`` continues the scan: T steps
    in one call equal the first 9 then the rest from the state they left,
    and equal the oracle from that state; ``out`` receives the state."""
    B, T, H, P, N = 2, 21, 2, 8, 16
    x, b, c, dt, a, d = map(torch.tensor, _model(11, B, T, H, P, N))
    y, s = ops.selective_scan(x, b, c, dt, a, d)
    y1, s1 = ops.selective_scan(x[:, :9], b[:, :9], c[:, :9], dt[:, :9], a, d)
    out = torch.empty_like(s1)
    y2, s2 = ops.selective_scan(x[:, 9:], b[:, 9:], c[:, 9:], dt[:, 9:], a,
                                d, s1, out=out)
    assert s2 is out
    _close(torch.cat([y1, y2], dim=1), y.numpy())
    _close(s2, s.numpy())
    y_want, s_want = oracle_jax(*_broadcast_heads(
        *(v.numpy() for v in (x[:, 9:], b[:, 9:], c[:, 9:], dt[:, 9:], a, d,
                              s1))))
    _close(y2.transpose(1, 2).reshape(B * H, -1, P), y_want)
    _close(s2.reshape(B * H, P, N), s_want)


@pytest.mark.parametrize("dt_scale", [1e-6, 40.0])
def test_extreme_steps_match_oracle(dt_scale):
    """dt near 0 (decay near 1, the state kept) and large (decay near 0,
    the state forgotten at once), from a nonzero state, in the model
    layout against the reference's oracle."""
    B, T, H, P, N = 2, 50, 3, 16, 16
    arrays = _model(5, B, T, H, P, N, dt_scale)
    s0 = _state(8, B, H, P, N)
    y_want, s_want = oracle_jax(*_broadcast_heads(*arrays, s0))
    y, s = ops.selective_scan(*map(torch.tensor, arrays), torch.tensor(s0))
    _close(y.transpose(1, 2).reshape(B * H, T, P), y_want)
    _close(s.reshape(B * H, P, N), s_want)


def test_one_step_and_no_step():
    """T = 1 (the decode step) is one step of the recurrence; T = 0 gives no
    output and hands the state back."""
    B, H, P, N = 2, 3, 8, 4
    x, b, c, dt, a, d = map(torch.tensor, _model(9, B, 1, H, P, N))
    s0 = torch.tensor(_state(10, B, H, P, N))
    y, s = ops.selective_scan(x, b, c, dt, a, d, s0)
    decay = torch.exp(dt[:, 0] * a)[..., None, None]
    want_s = decay * s0 + (dt[:, 0, :, None] * x[:, 0])[..., None] * b[
        :, 0, None, None, :]
    _close(s, want_s.numpy())
    want_y = torch.einsum("bhpn,bn->bhp", want_s, c[:, 0]) + d[:, None] * x[
        :, 0]
    _close(y[:, 0], want_y.numpy())
    y0, s_0 = ops.selective_scan(x[:, :0], b[:, :0], c[:, :0], dt[:, :0], a,
                                 d, s0)
    assert y0.shape == (B, 0, H, P)
    np.testing.assert_array_equal(s_0.numpy(), s0.numpy())
    y0, s_0 = ops.selective_scan(x[:, :0], b[:, :0], c[:, :0], dt[:, :0], a,
                                 d)
    assert not s_0.any() and s_0.shape == (B, H, P, N)


def test_ssd_stepwise_matches_reference():
    """The port's ``ssd_stepwise`` (the plain version with no skip) against
    the reference's, from a nonzero state."""
    B, T, H, P, N = 2, 13, 3, 8, 16
    x, b, c, dt, a, _ = _model(12, B, T, H, P, N)
    s0 = _state(13, B, H, P, N)
    y_want, s_want = ssm_ref.ssd_stepwise(*map(jnp.asarray, (x, b, c, dt, a,
                                                             s0)))
    y, s = ssm.ssd_stepwise(*map(torch.tensor, (x, b, c, dt, a, s0)))
    _close(y, y_want)
    _close(s, s_want)


def test_kernel_wrapper_checks_its_inputs():
    """The wrapper refuses what the kernel does not take, and a CPU tensor
    never reaches a launch."""
    B, T, H, P, N = 2, 4, 3, 8, 16
    x = torch.zeros(B, T, H, P)
    bc = torch.zeros(B, T, N)
    dt = torch.zeros(B, T, H)
    a = torch.zeros(H)
    s0 = torch.zeros(B, H, P, N)
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.ssm_scan(x, bc, bc, dt, a, a, s0)
    with pytest.raises(ValueError, match="c must be"):
        kernel.ssm_scan(x, bc, torch.zeros(B, T + 1, N), dt, a, a)
    with pytest.raises(ValueError, match="dt must be"):
        kernel.ssm_scan(x, bc, bc, torch.zeros(B, T), a, a)
    with pytest.raises(ValueError, match="a must be"):
        kernel.ssm_scan(x, bc, bc, dt, torch.zeros(B, H), a)
    with pytest.raises(ValueError, match="d must be"):
        kernel.ssm_scan(x, bc, bc, dt, a, torch.zeros(H + 1))
    with pytest.raises(ValueError, match="state0 must be"):
        kernel.ssm_scan(x, bc, bc, dt, a, a, torch.zeros(B, H, P, N + 1))
    with pytest.raises(ValueError, match="out must be"):
        kernel.ssm_scan(x, bc, bc, dt, a, a, out=torch.zeros(B, H, P))
    with pytest.raises(ValueError, match="P <= 64"):
        big = torch.zeros(1, T, 1, 80)
        kernel.ssm_scan(big, bc[:1], bc[:1], dt[:1, :, :1], a[:1], a[:1])
    with pytest.raises(ValueError, match="N <= 64"):
        wide = torch.zeros(B, T, 80)
        kernel.ssm_scan(x, wide, wide, dt, a, a)
    with pytest.raises(ValueError, match=r"\(B,T,H,P\)"):
        kernel.ssm_scan(x[0], bc, bc, dt, a, a)
    with pytest.raises(TypeError, match="float32"):
        kernel.ssm_scan(x.half(), bc, bc, dt, a, a)
    with pytest.raises(TypeError, match="float32"):
        kernel.ssm_scan(x, bc, bc, dt, a, a, s0.double())
    # on meta (the dry run's trace) the meta operator stands in: the
    # kernel's shapes, no launch
    y, state = ops.selective_scan(*(t.to("meta")
                                    for t in (x, bc, bc, dt, a, a)))
    assert y.device.type == "meta" and y.shape == x.shape
    assert state.shape == s0.shape and state.dtype == torch.float32
    assert kernel.ssm_scan.launches == 0
    assert kernel.LIBRARIES == {"ssm_scan": [
        kernel.SOURCE, kernel.CHUNKED_SOURCE, kernel.DECODE_SOURCE],
        "ssm_backward": [kernel.BWD_SOURCE]}
    assert all(src.is_file() for srcs in kernel.LIBRARIES.values()
               for src in srcs)
    # the backward's source holds its two kernels, chunked on 3xTF32
    # tensor cores; the earlier one-block-per-(b, h) kernel is gone
    bwd = kernel.BWD_SOURCE.read_text()
    assert all(f"ssm_bwd_{k}_kernel(" in bwd for k in kernel.BWD_KERNELS)
    assert "ssm_bwd_kernel" not in bwd and "mma_3xtf32" in bwd
