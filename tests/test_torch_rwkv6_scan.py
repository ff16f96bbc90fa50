"""The RWKV6 WKV scan of the port on the CPU, held to the JAX package.

The port's plain versions (``kernels/rwkv6_scan/ref.py``) are what the CUDA
kernel is held to on the card (``chip_smoke.py``), so here they are held to
the reference: to the Pallas kernel in interpret mode from a zero state at
``tests/test_kernels.py::test_rwkv6_scan_sweep``'s shapes and tolerance,
to the reference's oracle ``rwkv6_scan_ref`` from a nonzero state, and, in
the model layout, ``ops.wkv`` to the reference's ``ops.wkv`` in interpret
mode.  Inputs come from numpy seeds and go to both, drawn as the
reference's test draws them.  The wrapper refuses what the kernel does not
take; a CUDA launch cannot run here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_scan.kernel import rwkv6_scan as pallas_scan
from repro.kernels.rwkv6_scan.ops import wkv as wkv_jax
from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref as oracle_jax
from repro_torch.kernels.rwkv6_scan import kernel, ops, ref

# the reference's tolerance (tests/test_kernels.py), atol = rtol
TOL = 1e-4
# (BH, T, N, chunk) of tests/test_kernels.py::test_rwkv6_scan_sweep
SWEEP = [(4, 64, 16, 32), (2, 100, 32, 32), (3, 17, 8, 8), (1, 256, 64, 128)]


def _inputs(seed, lead, N, u_lead):
    """r, k, v (0.5 normal), w (sigmoid(normal) * 0.5 + 0.45, in (0.45,
    0.95)) of shape (*lead, N) and u (0.1 normal) of (*u_lead, N), float32
    numpy: the reference test's laws."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((*lead, N)).astype(np.float32) * 0.5
               for _ in range(3))
    w = (0.5 / (1 + np.exp(-rng.standard_normal((*lead, N)))) + 0.45
         ).astype(np.float32)
    u = rng.standard_normal((*u_lead, N)).astype(np.float32) * 0.1
    return r, k, v, w, u


def _state(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("BH,T,N,chunk", SWEEP)
def test_plain_version_matches_pallas_kernel(BH, T, N, chunk):
    arrays = _inputs(BH * 1000 + T, (BH, T), N, (BH,))
    y_want, s_want = pallas_scan(*map(jnp.asarray, arrays), chunk=chunk,
                                 interpret=True)
    y, s = ref.rwkv6_scan_ref(*map(torch.tensor, arrays))
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    _close(y, y_want)
    _close(s, s_want)


@pytest.mark.parametrize("BH,T,N", [(4, 64, 16), (3, 17, 8), (2, 33, 64)])
def test_plain_version_matches_oracle_from_a_state(BH, T, N):
    arrays = _inputs(T, (BH, T), N, (BH,))
    s0 = _state(T + 1, BH, N, N)
    y_want, s_want = oracle_jax(*map(jnp.asarray, arrays), jnp.asarray(s0))
    y, s = ref.rwkv6_scan_ref(*map(torch.tensor, arrays), torch.tensor(s0))
    _close(y, y_want)
    _close(s, s_want)


def test_wkv_matches_reference_ops():
    """``ops.wkv`` (the model layout, one bonus per head) from a zero
    state, against the reference's ``ops.wkv`` in interpret mode."""
    B, T, H, N = 2, 40, 3, 16
    arrays = _inputs(7, (B, T, H), N, (H,))
    y_want, s_want = wkv_jax(*map(jnp.asarray, arrays), chunk=16,
                             interpret=True)
    y, s = ops.wkv(*map(torch.tensor, arrays))
    assert y.shape == (B, T, H, N) and s.shape == (B, H, N, N)
    _close(y, y_want)
    _close(s, s_want)


def test_wkv_carries_a_state_in_two_pieces():
    """A state given to ``ops.wkv`` continues the scan: T steps in one call
    equal the first 9 then the rest from the state they left, and equal the
    oracle from that state; ``out`` receives the state."""
    B, T, H, N = 2, 21, 2, 8
    r, k, v, w, u = map(torch.tensor, _inputs(11, (B, T, H), N, (H,)))
    y, s = ops.wkv(r, k, v, w, u)
    y1, s1 = ops.wkv(r[:, :9], k[:, :9], v[:, :9], w[:, :9], u)
    out = torch.empty_like(s1)
    y2, s2 = ops.wkv(r[:, 9:], k[:, 9:], v[:, 9:], w[:, 9:], u, s1, out=out)
    assert s2 is out
    _close(torch.cat([y1, y2], dim=1), y.numpy())
    _close(s2, s.numpy())

    def flat(a):
        return jnp.asarray(a.transpose(1, 2).reshape(B * H, -1, N).numpy())

    y_want, s_want = oracle_jax(
        *(flat(a[:, 9:]) for a in (r, k, v, w)),
        jnp.asarray(np.broadcast_to(u.numpy(), (B, H, N)).reshape(B * H, N)),
        jnp.asarray(s1.reshape(B * H, N, N).numpy()))
    _close(y2.transpose(1, 2).reshape(B * H, -1, N), y_want)
    _close(s2.reshape(B * H, N, N), s_want)


@pytest.mark.parametrize("lo,hi", [(1e-6, 1e-3), (0.999, 1.0 - 1e-7)])
def test_extreme_decays_match_oracle(lo, hi):
    """Decays near 0 (the state forgets at once) and near 1 (it keeps
    everything), from a nonzero state."""
    BH, T, N = 3, 50, 16
    r, k, v, _, u = _inputs(5, (BH, T), N, (BH,))
    w = np.random.default_rng(6).uniform(lo, hi, (BH, T, N)).astype(
        np.float32)
    s0 = _state(8, BH, N, N)
    y_want, s_want = oracle_jax(*map(jnp.asarray, (r, k, v, w, u, s0)))
    y, s = ref.rwkv6_scan_ref(*map(torch.tensor, (r, k, v, w, u, s0)))
    _close(y, y_want)
    _close(s, s_want)


def test_one_step_and_no_step():
    """T = 1 (the decode step) is one step of the recurrence; T = 0 gives no
    output and hands the state back."""
    B, H, N = 2, 3, 8
    r, k, v, w, u = map(torch.tensor, _inputs(9, (B, 1, H), N, (H,)))
    s0 = torch.tensor(_state(10, B, H, N, N))
    y, s = ops.wkv(r, k, v, w, u, s0)
    kv = k[:, 0, :, :, None] * v[:, 0, :, None, :]
    want_y = torch.einsum("bhn,bhnm->bhm", r[:, 0], s0 + u[..., None] * kv)
    _close(y[:, 0], want_y.numpy())
    _close(s, (w[:, 0, :, :, None] * s0 + kv).numpy())
    y0, s_0 = ops.wkv(r[:, :0], k[:, :0], v[:, :0], w[:, :0], u, s0)
    assert y0.shape == (B, 0, H, N)
    np.testing.assert_array_equal(s_0.numpy(), s0.numpy())


def test_kernel_wrapper_checks_its_inputs():
    """The wrapper refuses what the kernel does not take, and a CPU tensor
    never reaches a launch."""
    B, T, H, N = 2, 4, 3, 8
    x = torch.zeros(B, T, H, N)
    u = torch.zeros(H, N)
    s0 = torch.zeros(B, H, N, N)
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.rwkv6_scan(x, x, x, x, u, s0)
    with pytest.raises(ValueError, match="share one shape"):
        kernel.rwkv6_scan(x, x, x, torch.zeros(B, T + 1, H, N), u)
    with pytest.raises(ValueError, match="u must be"):
        kernel.rwkv6_scan(x, x, x, x, torch.zeros(B, H, N))
    with pytest.raises(ValueError, match="state0 must be"):
        kernel.rwkv6_scan(x, x, x, x, u, torch.zeros(B, H, N, N + 1))
    with pytest.raises(ValueError, match="out must be"):
        kernel.rwkv6_scan(x, x, x, x, u, out=torch.zeros(B, H, N))
    with pytest.raises(ValueError, match="N <= 64"):
        big = torch.zeros(1, T, 1, 80)
        kernel.rwkv6_scan(big, big, big, big, torch.zeros(1, 80))
    with pytest.raises(ValueError, match=r"\(B,T,H,N\)"):
        kernel.rwkv6_scan(x[0], x[0], x[0], x[0], u)
    with pytest.raises(TypeError, match="float32"):
        h = x.half()
        kernel.rwkv6_scan(h, h, h, h, u)
    with pytest.raises(TypeError, match="float32"):
        kernel.rwkv6_scan(x, x, x, x, u, s0.double())
    # on meta (the dry run's trace) the meta operator stands in: the
    # kernel's shapes, no launch
    m = x.to("meta")
    y, state = ops.wkv(m, m, m, m, u.to("meta"))
    assert y.device.type == "meta" and y.shape == x.shape
    assert state.shape == s0.shape and state.dtype == torch.float32
    assert kernel.rwkv6_scan.launches == 0
    assert kernel.rwkv6_scan.launches_by_kernel == {"chunked": 0,
                                                    "decode_rows": 0}
    sources = [kernel.SOURCE, kernel.CHUNKED_SOURCE, kernel.DECODE_SOURCE]
    assert kernel.LIBRARIES == {"rwkv6_scan": sources,
                                "rwkv6_backward": [kernel.BWD_SOURCE]}
    assert all(src.is_file() for src in [*sources, kernel.BWD_SOURCE])
    assert (kernel.CSRC.parent.parent / "csrc" / "cp_async.cuh").is_file()
