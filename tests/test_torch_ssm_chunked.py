"""The Hopper selective-scan kernels' algorithms in plain PyTorch, held to
the JAX package on the CPU.

``ref.ssd_chunked_ref`` is the prefill kernel's algorithm
(``csrc/ssm_chunked.cu``): Mamba2's chunked SSD form with float64 segment
sums and, with ``operand_rounding="tf32x3"``, the kernel's 3xTF32 rounding
of every product's operands.  Here it is held, at chunks of 16, 32 and 64,
with and without that rounding, to the reference's ``ssd_chunked`` (the
XLA form, plus the skip), to the reference's Pallas ``ssm_scan`` in
interpret mode (from a zero state, which is all it takes) or its oracle
(from a nonzero state), and to the port's step-by-step
``selective_scan_ref``.  ``ref.ssm_decode_rows_ref`` is the decode
kernel's (``csrc/ssm_decode.cu``): a state row split over lanes, summed in
their order.  Inputs come from numpy seeds with the reference test's laws;
tolerance atol = rtol = 1e-4, the reference's (tests/test_kernels.py).
The CUDA kernels run only on a card, where ``chip_smoke.py`` holds them to
these plain versions.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.kernel import ssm_scan as pallas_scan
from repro.kernels.ssm_scan.ref import ssm_scan_ref as oracle_jax
from repro.models import ssm as ssm_jax
from repro_torch.kernels import _fp
from repro_torch.kernels.ssm_scan import kernel, ref

TOL = 1e-4
# (label, (B, T, H, P, N), state, dt scale): a zero and a nonzero state,
# steps near 0 (decays near 1) and large (dt x 40: the prefix sums of dt a
# reach thousands within a chunk) at the served P = N = 64, T ragged
# against every chunk (33, 77), and T = 1
CASES = [
    ("zero state", (2, 40, 3, 16, 8), False, 1.0),
    ("state", (2, 77, 3, 32, 16), True, 1.0),
    ("dt~0", (2, 50, 2, 16, 16), True, 1e-6),
    ("dt large", (1, 90, 2, 64, 64), True, 40.0),
    ("ragged", (1, 33, 2, 24, 24), False, 1.0),
    ("T=1", (3, 1, 2, 8, 4), True, 1.0),
]
CHUNKS = [16, 32, 64]


def _softplus(v):
    return np.log1p(np.exp(-np.abs(v))) + np.maximum(v, 0)


@functools.lru_cache(maxsize=None)
def _case(label):
    """x normal (B,T,H,P), b and c 0.3 normal (B,T,N), dt softplus(normal)
    (B,T,H) times the case's scale, a = -exp(normal) (times 3 at the
    large-step case, down to about -20) and d normal (H,), state0 normal
    (B,H,P,N) or None; float32 numpy."""
    i, (_, (B, T, H, P, N), state, scale) = next(
        (i, c) for i, c in enumerate(CASES) if c[0] == label)
    rng = np.random.default_rng(100 + i)
    x = rng.standard_normal((B, T, H, P))
    b, c = (rng.standard_normal((B, T, N)) * 0.3 for _ in range(2))
    dt = _softplus(rng.standard_normal((B, T, H))) * scale
    a = -np.exp(rng.standard_normal(H)) * (3.0 if scale > 1 else 1.0)
    d = rng.standard_normal(H)
    s0 = rng.standard_normal((B, H, P, N)) if state else None
    return tuple(None if v is None else v.astype(np.float32)
                 for v in (x, b, c, dt, a, d, s0))


def _torch(arrays):
    return [None if v is None else torch.tensor(v) for v in arrays]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=TOL)


def _flat(x, b, c, dt, a, d, s0=None):
    """The model layout as the reference kernel's flat layout: row (b, h),
    b and c repeated per head."""
    B, T, H, P = x.shape
    N = b.shape[-1]
    flat = [x.transpose(0, 2, 1, 3).reshape(B * H, T, P),
            np.broadcast_to(b[:, None], (B, H, T, N)).reshape(B * H, T, N),
            np.broadcast_to(c[:, None], (B, H, T, N)).reshape(B * H, T, N),
            dt.transpose(0, 2, 1).reshape(B * H, T),
            np.broadcast_to(a, (B, H)).reshape(B * H),
            np.broadcast_to(d, (B, H)).reshape(B * H)]
    if s0 is not None:
        flat.append(s0.reshape(B * H, P, N))
    return [jnp.asarray(np.ascontiguousarray(v)) for v in flat]


@functools.lru_cache(maxsize=None)
def _pallas_or_oracle(label):
    """The reference kernel's (y, state) in the model layout: the Pallas
    kernel in interpret mode from a zero state, its oracle from any
    other."""
    x, b, c, dt, a, d, s0 = _case(label)
    B, T, H, P = x.shape
    if s0 is None:
        y, s = pallas_scan(*_flat(x, b, c, dt, a, d), chunk=32,
                           interpret=True)
    else:
        y, s = oracle_jax(*_flat(x, b, c, dt, a, d, s0))
    y = np.asarray(y).reshape(B, H, T, P).transpose(0, 2, 1, 3)
    return y, np.asarray(s).reshape(s0.shape if s0 is not None else
                                    (B, H, P, b.shape[-1]))


@functools.lru_cache(maxsize=None)
def _ssd_jax(label, chunk):
    """The reference's ``models/ssm.py: ssd_chunked`` (no skip) plus the
    skip d x, as its Mamba2 block adds it."""
    x, b, c, dt, a, d, s0 = _case(label)
    B, H, P, N = x.shape[0], x.shape[2], x.shape[3], b.shape[-1]
    h0 = np.zeros((B, H, P, N), np.float32) if s0 is None else s0
    y, s = ssm_jax.ssd_chunked(*map(jnp.asarray, (x, b, c, dt, a, h0)),
                               chunk=chunk)
    return np.asarray(y) + d[None, None, :, None] * x, np.asarray(s)


@pytest.mark.parametrize("rounding", [None, "tf32x3"])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_chunked_algorithm_matches_references(label, chunk, rounding):
    arrays = _torch(_case(label))
    y, s = ref.ssd_chunked_ref(*arrays, chunk=chunk,
                               operand_rounding=rounding)
    assert y.dtype == s.dtype == torch.float32
    assert y.shape == arrays[0].shape
    for want in (_ssd_jax(label, chunk), _pallas_or_oracle(label),
                 ref.selective_scan_ref(*arrays)):
        _close(y, want[0])
        _close(s, want[1])


def test_single_tf32_products_miss_the_tolerance():
    """Why the kernel splits its operands: with each operand rounded once
    to TF32 (10 mantissa bits) the chunked form misses 1e-4 where 3xTF32
    holds it."""
    arrays = _torch(_case("state"))
    want = ref.selective_scan_ref(*arrays)[0]
    errs = {r: float(((ref.ssd_chunked_ref(*arrays, operand_rounding=r)[0]
                       - want).abs() - TOL * want.abs()).max())
            for r in ("tf32", "tf32x3")}
    assert errs["tf32"] > TOL >= errs["tf32x3"], errs


def test_tf32_rounding_is_round_to_nearest_ties_away():
    """``_fp.tf32`` rounds as ``cvt.rna.tf32.f32``: 10 mantissa bits kept,
    a half unit rounded away from zero, the exponent carried."""
    ulp = 2.0**-10
    v = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 4,
                      2.0 - ulp / 2, 3.0], dtype=torch.float32)
    want = torch.tensor([1.0 + ulp, -(1.0 + ulp), 1.0, 2.0, 3.0])
    assert torch.equal(_fp.tf32(v), want)
    with pytest.raises(ValueError, match="operand_rounding"):
        ref.ssd_chunked_ref(*_torch(_case("T=1")), operand_rounding="bf16")


@pytest.mark.parametrize("lanes", [None, 16, 32])
@pytest.mark.parametrize("label,T", [("dt large", 1), ("state", 5),
                                     ("T=1", 1), ("ragged", 3)])
def test_decode_rows_algorithm_matches_references(label, T, lanes):
    """The decode kernel's split of a state row over lanes (its own count
    by default: 16 at N = 64, 4 at N = 16, 1 at N = 4), at the first T
    steps of a case, against the oracle and the step-by-step plain
    version."""
    x, b, c, dt, a, d, s0 = _case(label)
    N = b.shape[-1]
    x, b, c, dt = (v[:, :T] for v in (x, b, c, dt))
    arrays = _torch((x, b, c, dt, a, d, s0))
    y, s = ref.ssm_decode_rows_ref(*arrays, lanes=lanes)
    B, H, P = x.shape[0], x.shape[2], x.shape[3]
    flat = _flat(x, b, c, dt, a, d,
                 np.zeros((B, H, P, N), np.float32) if s0 is None else s0)
    y_want, s_want = oracle_jax(*flat)
    _close(y.transpose(1, 2).reshape(B * H, T, P), y_want)
    _close(s.reshape(B * H, P, N), s_want)
    y_plain, s_plain = ref.selective_scan_ref(*arrays)
    _close(y, y_plain)
    _close(s, s_plain)


def test_decode_rows_refuses_too_few_lanes():
    with pytest.raises(ValueError, match="lanes"):
        ref.ssm_decode_rows_ref(*_torch(_case("state")), lanes=2)
    with pytest.raises(ValueError, match="lanes"):
        ref.ssm_decode_rows_ref(*_torch(_case("state")), lanes=6)


def test_kernel_dispatch_and_lanes():
    """Every decode step (T = 1) and any T up to DECODE_MAX_T takes the
    row-split kernel, every longer T (each prefill) the chunked one; a
    state row of N is split over the power of two >= N / 4 lanes."""
    assert kernel.KERNELS == {"chunked": 0, "decode_rows": 1}
    assert kernel.ssm_scan.launches_by_kernel == {"chunked": 0,
                                                  "decode_rows": 0}
    assert [kernel.kernel_for(T) for T in (1, kernel.DECODE_MAX_T,
                                           kernel.DECODE_MAX_T + 1, 32, 512)
            ] == ["decode_rows", "decode_rows", "chunked", "chunked",
                  "chunked"]
    assert [ref.decode_lanes(N) for N in (1, 4, 5, 10, 16, 17, 64)] == [
        1, 1, 2, 4, 4, 8, 16]
    assert kernel.CHUNK == 64
