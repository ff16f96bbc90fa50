"""The Hopper WKV-scan kernels' algorithms in plain PyTorch, held to the
JAX package on the CPU.

``ref.wkv_chunked_ref`` is the prefill kernel's algorithm
(``csrc/rwkv6_chunked.cu``): the chunked WKV form with every decay a
running product of w inside the chunk and, with
``operand_rounding="tf32x3"``, the kernel's 3xTF32 rounding of its three
products' operands.  Here it is held, at chunks of 8, 16 (the kernel's)
and 64, at blocks of 8 and 32 value columns, with and without that
rounding, to the reference's Pallas ``rwkv6_scan`` in interpret mode (from
a zero state, which is all it takes) or its oracle ``rwkv6_scan_ref``
(from a nonzero state), to the reference's ``models/rwkv.py:
wkv_chunked`` (the log-space form) and to the port's step-by-step
``wkv_ref``, over decays near 0, near 1 and the model's own
exp(-exp(dw)) with dw up to 5 (many exactly 0), head sizes that are no
power of two or no multiple of 4, and T that are no multiple of the
chunk.  ``ref.wkv_decode_rows_ref`` is the decode kernel's
(``csrc/rwkv6_decode.cu``): a state column split over lanes, summed in
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

from repro.kernels.rwkv6_scan.kernel import rwkv6_scan as pallas_scan
from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref as oracle_jax
from repro.models import rwkv as rwkv_jax
from repro_torch.kernels.rwkv6_scan import kernel, ref

TOL = 1e-4
# (label, (B, T, H, N), state, decays): decays None are the reference
# test's sigmoid(normal) * 0.5 + 0.45; ("uniform", lo, hi) or the model's
# ("dw", lo, hi), w = exp(-exp(dw)) with dw uniform on (lo, hi)
CASES = [
    ("zero state", (2, 40, 3, 16), False, None),
    ("state", (2, 77, 2, 32), True, None),
    ("decay~0", (2, 50, 2, 16), True, ("uniform", 1e-6, 1e-3)),
    ("decay~1", (1, 90, 2, 64), True, ("uniform", 0.999, 1 - 1e-7)),
    ("dw to 5", (1, 70, 2, 64), True, ("dw", -6.0, 5.0)),
    ("N=24 ragged", (1, 33, 2, 24), False, None),
    ("N=10", (2, 21, 2, 10), True, None),
    ("T=1", (3, 1, 2, 8), True, None),
]
CHUNKS = [8, 16, 64]
COLS = [8, 32]


@functools.lru_cache(maxsize=None)
def _case(label):
    """r, k, v 0.5 normal (B,T,H,N), the case's decays w, u 0.1 normal
    (H,N), state0 normal (B,H,N,N) or None; float32 numpy."""
    i, (_, (B, T, H, N), state, decays) = next(
        (i, c) for i, c in enumerate(CASES) if c[0] == label)
    rng = np.random.default_rng(200 + i)
    r, k, v = (rng.standard_normal((B, T, H, N)) * 0.5 for _ in range(3))
    if decays is None:
        w = 0.5 / (1 + np.exp(-rng.standard_normal((B, T, H, N)))) + 0.45
    elif decays[0] == "uniform":
        w = rng.uniform(*decays[1:], (B, T, H, N))
    else:
        w = np.exp(-np.exp(rng.uniform(*decays[1:], (B, T, H, N))))
    u = rng.standard_normal((H, N)) * 0.1
    s0 = rng.standard_normal((B, H, N, N)) if state else None
    return tuple(None if a is None else a.astype(np.float32)
                 for a in (r, k, v, w, u, s0))


def _torch(arrays):
    return [None if a is None else torch.tensor(a) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=TOL)


def _flat(r, k, v, w, u):
    """The model layout as the reference kernel's flat layout: row (b, h),
    u repeated per batch row."""
    B, T, H, N = r.shape
    flat = [a.transpose(0, 2, 1, 3).reshape(B * H, T, N)
            for a in (r, k, v, w)]
    flat.append(np.broadcast_to(u, (B, H, N)).reshape(B * H, N))
    return [jnp.asarray(np.ascontiguousarray(a)) for a in flat]


def _model_layout(y, s, B, H):
    """(y (BH,T,N), state (BH,N,N)) of the flat layout in the model's."""
    BH, T, N = y.shape
    return (np.asarray(y).reshape(B, H, T, N).transpose(0, 2, 1, 3),
            np.asarray(s).reshape(B, H, N, N))


@functools.lru_cache(maxsize=None)
def _pallas_or_oracle(label):
    """The reference kernel's (y, state) in the model layout: the Pallas
    kernel in interpret mode from a zero state, its oracle from any
    other."""
    r, k, v, w, u, s0 = _case(label)
    B, T, H, N = r.shape
    if s0 is None:
        y, s = pallas_scan(*_flat(r, k, v, w, u), chunk=min(32, T),
                           interpret=True)
    else:
        y, s = oracle_jax(*_flat(r, k, v, w, u),
                          jnp.asarray(s0.reshape(B * H, N, N)))
    return _model_layout(y, s, B, H)


@functools.lru_cache(maxsize=None)
def _wkv_chunked_jax(label):
    """The reference's ``models/rwkv.py: wkv_chunked``, the log-space
    chunked form, in chunks of 16."""
    r, k, v, w, u, s0 = _case(label)
    B, T, H, N = r.shape
    S = np.zeros((B, H, N, N), np.float32) if s0 is None else s0
    y, s = rwkv_jax.wkv_chunked(*map(jnp.asarray, (r, k, v, w, u, S)),
                                chunk=16)
    return np.asarray(y), np.asarray(s)


@pytest.mark.parametrize("rounding", [None, "tf32x3"])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_chunked_algorithm_matches_references(label, chunk, rounding):
    arrays = _torch(_case(label))
    plain = ref.wkv_ref(*arrays)
    for cols in COLS:
        y, s = ref.wkv_chunked_ref(*arrays, chunk=chunk, cols=cols,
                                   operand_rounding=rounding)
        assert y.dtype == s.dtype == torch.float32
        assert y.shape == arrays[0].shape
        for want in (_pallas_or_oracle(label), _wkv_chunked_jax(label),
                     plain):
            _close(y, want[0])
            _close(s, want[1])


def test_single_tf32_products_miss_the_tolerance():
    """Why the kernel splits its operands: with each operand rounded once
    to TF32 (10 mantissa bits) the chunked form misses 1e-4 where 3xTF32
    holds it."""
    arrays = _torch(_case("state"))
    want = ref.wkv_ref(*arrays)[0]
    errs = {r: float(((ref.wkv_chunked_ref(*arrays, operand_rounding=r)[0]
                       - want).abs() - TOL * want.abs()).max())
            for r in ("tf32", "tf32x3")}
    assert errs["tf32"] > TOL >= errs["tf32x3"], errs


def test_chunked_refuses_what_it_does_not_take():
    arrays = _torch(_case("T=1"))
    with pytest.raises(ValueError, match="operand_rounding"):
        ref.wkv_chunked_ref(*arrays, operand_rounding="bf16")
    with pytest.raises(ValueError, match="chunk and cols"):
        ref.wkv_chunked_ref(*arrays, chunk=0)


@pytest.mark.parametrize("lanes", [None, 16, 32])
@pytest.mark.parametrize("label,T", [("decay~1", 1), ("state", 5),
                                     ("dw to 5", 8), ("N=10", 3),
                                     ("T=1", 1), ("N=24 ragged", 2)])
def test_decode_rows_algorithm_matches_references(label, T, lanes):
    """The decode kernel's split of a state column over lanes (its own
    count by default: 16 at N = 64, 8 at N = 24 and 32, 4 at N = 10 and
    16, 2 at N = 8), at the first T steps of a case, against the oracle
    and the step-by-step plain version."""
    r, k, v, w, u, s0 = _case(label)
    B, _, H, N = r.shape
    r, k, v, w = (a[:, :T] for a in (r, k, v, w))
    state = np.zeros((B, H, N, N), np.float32) if s0 is None else s0
    arrays = _torch((r, k, v, w, u, state))
    y, s = ref.wkv_decode_rows_ref(*arrays, lanes=lanes)
    y_want, s_want = _model_layout(
        *oracle_jax(*_flat(r, k, v, w, u),
                    jnp.asarray(state.reshape(B * H, N, N))), B, H)
    _close(y, y_want)
    _close(s, s_want)
    y_plain, s_plain = ref.wkv_ref(*arrays)
    _close(y, y_plain)
    _close(s, s_plain)


def test_decode_rows_refuses_too_few_lanes():
    with pytest.raises(ValueError, match="lanes"):
        ref.wkv_decode_rows_ref(*_torch(_case("state")), lanes=4)
    with pytest.raises(ValueError, match="lanes"):
        ref.wkv_decode_rows_ref(*_torch(_case("state")), lanes=12)


def test_kernel_dispatch_and_lanes():
    """Every decode step (T = 1) and any T up to DECODE_MAX_T takes the
    row-split kernel, every longer T (each prefill, the serve's buckets)
    the chunked one; a state column of N is split over the power of two
    >= N / 4 lanes; the chunked kernel takes 16 steps a chunk and 32 value
    columns a block."""
    assert kernel.KERNELS == {"chunked": 0, "decode_rows": 1}
    assert kernel.rwkv6_scan.launches_by_kernel == {"chunked": 0,
                                                    "decode_rows": 0}
    assert [kernel.kernel_for(T) for T in (1, kernel.DECODE_MAX_T,
                                           kernel.DECODE_MAX_T + 1, 16, 17,
                                           32, 512)
            ] == ["decode_rows", "decode_rows", "chunked", "chunked",
                  "chunked", "chunked", "chunked"]
    assert [ref.decode_lanes(N) for N in (1, 4, 5, 10, 24, 64)] == [
        1, 1, 2, 4, 8, 16]
    assert (kernel.CHUNK, kernel.COLS) == (16, 32)
