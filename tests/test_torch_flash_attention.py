"""Flash attention of the port on the CPU, held to the JAX package.

The port's plain versions (``kernels/flash_attention/ref.py``) are what the
CUDA kernel is held to on the card (``chip_smoke.py``), so here they are
held to the reference: to the Pallas kernel in interpret mode at
``tests/test_kernels.py::test_flash_attention_sweep``'s shapes and
tolerances, to the reference's ``gqa_flash``, and, in the positions form,
to ``attend_full_ref`` with unwritten slots, a window and the decode shape.
The port's chunked ``attend`` (the CPU path of the model) is held to the
reference's ``attend``.  Inputs come from numpy seeds and go to both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as pallas_fa
from repro.kernels.flash_attention.ops import gqa_flash as gqa_flash_ref
from repro.models.attention import attend as attend_jax
from repro.models.attention import attend_full_ref as attend_full_jax
from repro_torch.kernels.flash_attention import kernel, ops, ref
from repro_torch.models.attention import attend

# the reference's tolerances (tests/test_kernels.py: tol), atol = rtol
TOL = {"float32": 2e-5, "bfloat16": 5e-2}
# the port's plain versions against the reference's in float32
ATOL = 2e-5


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _pair(a, dtype):
    """One numpy array as the reference's array and the port's tensor, in
    ``dtype`` (both round the same float32 values)."""
    return jnp.asarray(a, getattr(jnp, dtype)), torch.tensor(
        a, dtype=getattr(torch, dtype))


def _positions(B, Sq, Sk, seed, holes=True, decode=False):
    """q_pos (B,Sq) and kv_pos (B,Sk) int32: arange, with some slots
    unwritten (-1) when ``holes``; at ``decode`` each row's query sits at
    its own position and the slots after it are unwritten."""
    rng = np.random.default_rng(seed)
    kv = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    if decode:
        q = rng.integers(Sk // 2, Sk, (B, Sq)).astype(np.int32)
        kv[kv > q[:, -1:]] = -1
    else:
        q = np.tile(np.arange(Sk - Sq, Sk, dtype=np.int32), (B, 1))
    if holes:
        kv[rng.random((B, Sk)) < 0.2] = -1
    return q, kv


@pytest.mark.parametrize("B,H,S,D,causal,window", [
    (2, 2, 128, 32, True, 0),
    (1, 4, 256, 64, True, 0),
    (2, 2, 100, 32, True, 0),  # ragged
    (2, 2, 250, 32, True, 64),  # SWA + ragged
    (1, 2, 77, 16, False, 0),  # non-causal
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_pallas_kernel(B, H, S, D, causal, window,
                                             dtype):
    q, k, v = _normal(0, *[(B, H, S, D)] * 3)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, k, v))
    want = pallas_fa(qj, kj, vj, causal=causal, window=window, block_q=64,
                     block_k=64, interpret=True)
    got = ref.attention_ref(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_gqa_flash_matches_reference():
    B, S, Hq, Hkv, D = 2, 96, 8, 2, 32
    q, k, v = _normal(1, (B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))
    want = gqa_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=True, interpret=True)
    got = ops.gqa_flash(*map(torch.tensor, (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window,decode", [
    (2, 40, 40, 4, 2, 32, True, 0, False),  # prefill, unwritten slots
    (2, 40, 40, 4, 2, 32, True, 16, False),  # sliding window
    (3, 1, 70, 8, 2, 16, True, 0, True),  # decode against a cache
    (3, 1, 70, 8, 2, 16, True, 24, True),  # decode with a window
    (1, 12, 30, 2, 1, 24, False, 0, False),  # cross-style, Sq != Sk
])
def test_positions_form_matches_attend_full_ref(B, Sq, Sk, Hq, Hkv, D, causal,
                                                window, decode):
    q, k, v = _normal(2, (B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))
    q_pos, kv_pos = _positions(B, Sq, Sk, seed=3, decode=decode)
    want = attend_full_jax(*map(jnp.asarray, (q, k, v, q_pos, kv_pos)),
                           causal=causal, window=window)
    got = ops.flash_attend(*map(torch.tensor, (q, k, v, q_pos, kv_pos)),
                           causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


def test_fully_masked_rows_are_zero():
    """A row with no slot to attend returns 0, as ``acc / max(l, 1e-30)``
    does: all slots unwritten in batch row 0, queries before every slot in
    batch row 1."""
    B, Sq, Sk, Hq, Hkv, D = 2, 6, 10, 4, 2, 8
    q, k, v = _normal(4, (B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))
    q_pos = np.tile(np.arange(Sq, dtype=np.int32) - 3, (B, 1))
    kv_pos = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    kv_pos[0] = -1
    got = ops.flash_attend(*map(torch.tensor, (q, k, v, q_pos, kv_pos)))
    want = attend_full_jax(*map(jnp.asarray, (q, k, v, q_pos, kv_pos)))
    assert (got[0] == 0).all() and (got[1, :3] == 0).all()
    assert got[1, 3:].abs().sum() > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


@pytest.mark.parametrize("Sq,Sk,chunk,window,p_dtype", [
    (96, 96, 32, 0, None),  # three full chunks
    (50, 50, 16, 0, None),  # ragged: the last chunk padded
    (50, 50, 16, 12, None),  # window
    (1, 70, 32, 0, None),  # decode
    (64, 64, 16, 0, "bfloat16"),  # p in bf16, accumulated in f32
])
def test_chunked_attend_matches_reference(Sq, Sk, chunk, window, p_dtype):
    B, Hq, Hkv, D = 2, 4, 2, 16
    q, k, v = _normal(5, (B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))
    q_pos, kv_pos = _positions(B, Sq, Sk, seed=6, decode=Sq == 1)
    want = attend_jax(*map(jnp.asarray, (q, k, v, q_pos, kv_pos)),
                      causal=True, window=window, chunk=chunk,
                      p_dtype=None if p_dtype is None else jnp.bfloat16)
    got = attend(*map(torch.tensor, (q, k, v, q_pos, kv_pos)), causal=True,
                 window=window, chunk=chunk,
                 p_dtype=None if p_dtype is None else torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)
    # the scan and the oracle compute one function
    full = ref.attend_full_ref(*map(torch.tensor, (q, k, v, q_pos, kv_pos)),
                               causal=True, window=window)
    if p_dtype is None:
        np.testing.assert_allclose(got.numpy(), full.numpy(), atol=ATOL,
                                   rtol=ATOL)


def test_kernel_wrapper_checks_its_inputs():
    """The wrapper refuses what the kernel does not take, and a CPU tensor
    never reaches a launch."""
    q = torch.zeros(1, 4, 4, 16)
    kv = torch.zeros(1, 4, 2, 16)
    pos = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.flash_attention(q, kv, kv, pos, pos)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        kernel.flash_attention(q, torch.zeros(1, 4, 3, 16),
                               torch.zeros(1, 4, 3, 16), pos, pos)
    with pytest.raises(ValueError, match="D <= 128"):
        big = torch.zeros(1, 4, 2, 136)
        kernel.flash_attention(torch.zeros(1, 4, 4, 136), big, big, pos, pos)
    with pytest.raises(TypeError, match="int32"):
        kernel.flash_attention(q, kv, kv, pos.long(), pos)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernel.flash_attention(q.half(), kv.half(), kv.half(), pos, pos)
    with pytest.raises(ValueError, match="do not match"):
        kernel.flash_attention(q, kv, kv, pos[:, :3], pos)
    assert kernel.flash_attention.launches == 0
