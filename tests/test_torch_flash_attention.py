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


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 3),
                                           (False, 0), (False, 3)])
def test_position_mask_is_a_query_by_slot_mask(causal, window):
    """(B, Sq, Sk) whatever the flags, not causal included: the pairs it
    lets through are what chip_smoke's bounds count."""
    q_pos = torch.zeros((2, 5), dtype=torch.int32)
    kv_pos = torch.tensor([[0, 1, -1, 3], [-1, -1, 2, 0]], dtype=torch.int32)
    mask = ref.position_mask(q_pos, kv_pos, causal, window)
    assert mask.shape == (2, 5, 4)
    # every query at 0: slot 0 alone when causal, every written slot not
    want = (kv_pos == 0) if causal else (kv_pos >= 0)
    assert torch.equal(mask, want[:, None, :].expand(2, 5, 4))


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
    with pytest.raises(ValueError, match="D <= 256"):
        big = torch.zeros(1, 4, 2, 264)
        kernel.flash_attention(torch.zeros(1, 4, 4, 264), big, big, pos, pos)
    with pytest.raises(TypeError, match="int32"):
        kernel.flash_attention(q, kv, kv, pos.long(), pos)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernel.flash_attention(q.half(), kv.half(), kv.half(), pos, pos)
    with pytest.raises(ValueError, match="do not match"):
        kernel.flash_attention(q, kv, kv, pos[:, :3], pos)
    assert kernel.flash_attention.launches == 0


# ---------------------------------------------------------------------------
# The algorithms of the card's kernels (kernels/flash_attention/ref.py:
# flash_decode_split_ref, the split decode's; attend_tc_ref, the wgmma
# prefill's) held to the reference
# ---------------------------------------------------------------------------

# attend_tc_ref on bf16 values against the reference in float32: P carries
# ~16 bits as P_hi + P_lo (P_hi its top 16 bits, |P - P_hi| < 2^-7 P, and
# P_lo that rest rounded to bf16, |P - P_hi - P_lo| <= 2^-16 P), so the
# output moves by at most ~2^-16 max|v| ~ 6e-5 at |v| <= 4 (standard
# normal v)
TC_ATOL = 1e-4
# bf16 outputs of two f32 computations of one function: one bf16 rounding
# step (2^-8 relative) apart at most, where the f32 values straddle it
BF16_ATOL = 1e-2


def _layout(kind, B, Sq, Sk, seed):
    """q_pos (B,Sq) and kv_pos (B,Sk) int32 and a window: "decode" (each
    query at its own position, later slots and 20% of the rest unwritten),
    "prefill" (queries at the last Sq positions, 20% of the slots
    unwritten), "ring" (a ring buffer: positions Sk//3 .. at slot position
    % Sk, so kv_pos is not sorted; every 5th slot unwritten; a window),
    "dead" (batch row 0 with no written slot, a hole of 21 slots in row
    1)."""
    rng = np.random.default_rng(seed)
    kv = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    q = np.tile(np.arange(Sk - Sq, Sk, dtype=np.int32), (B, 1))
    window = 0
    if kind == "decode":
        q = rng.integers(Sk // 2, Sk, (B, Sq)).astype(np.int32)
        kv[kv > q.max(axis=1, keepdims=True)] = -1
        kv[rng.random((B, Sk)) < 0.2] = -1
    elif kind == "prefill":
        kv[rng.random((B, Sk)) < 0.2] = -1
    elif kind == "ring":
        pos = np.arange(Sk // 3, Sk // 3 + Sk, dtype=np.int32)
        kv[:, pos % Sk] = pos
        kv[:, ::5] = -1
        q = np.tile(pos[Sk - Sq:], (B, 1))
        window = 24
    elif kind == "dead":
        kv[0] = -1
        kv[min(1, B - 1), 10:31] = -1
    return q, kv, window


def _bf16_values(a):
    """float32 values that bf16 holds exactly."""
    return torch.tensor(a).bfloat16().float().numpy()


@pytest.mark.parametrize("split", [1, 7, 64, 200])
@pytest.mark.parametrize("kind", ["decode", "prefill", "ring", "dead"])
@pytest.mark.parametrize("Hq,Hkv", [(8, 2), (4, 4)])
def test_decode_split_ref_matches_reference(split, kind, Hq, Hkv):
    """The split decode's algorithm at split sizes 1, 7, 64 and >= Sk,
    GQA and MHA, with holes, unsorted positions, a window, fully masked
    splits and rows, against the reference's attend_full_ref in float32."""
    B, Sq, Sk, D = 3, 2 if kind != "prefill" else 6, 70, 16
    q, k, v = _normal(7, (B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))
    q_pos, kv_pos, window = _layout(kind, B, Sq, Sk, seed=8)
    want = attend_full_jax(*map(jnp.asarray, (q, k, v, q_pos, kv_pos)),
                           causal=True, window=window)
    got = ref.flash_decode_split_ref(
        *map(torch.tensor, (q, k, v, q_pos, kv_pos)), causal=True,
        window=window, split=split)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)
    if kind == "dead":
        assert (got[0] == 0).all() and got[1].abs().sum() > 0


@pytest.mark.parametrize("split", [7, 64])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40),
                                           (False, 0)])
def test_decode_split_ref_matches_pallas_kernel(split, causal, window):
    """At arange positions, the reference's Pallas kernel in interpret mode
    (MHA, the (B,H,S,D) layout)."""
    B, H, S, D = 2, 2, 100, 32
    q, k, v = _normal(9, *[(B, H, S, D)] * 3)
    want = pallas_fa(*map(jnp.asarray, (q, k, v)), causal=causal,
                     window=window, block_q=64, block_k=64, interpret=True)
    qt, kt, vt = (torch.tensor(a).transpose(1, 2) for a in (q, k, v))
    pos = ref.arange_positions(B, S, "cpu")
    got = ref.flash_decode_split_ref(qt, kt, vt, pos, pos, causal=causal,
                                     window=window, split=split)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want),
                               atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("kind", ["decode", "ring", "dead"])
def test_decode_split_ref_bf16_matches_reference(kind):
    """bf16 inputs and output against the reference's attend in bf16."""
    B, Sq, Sk, Hq, Hkv, D = 2, 1, 150, 8, 2, 32
    arrays = _normal(10, (B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, "bfloat16") for a in arrays)
    q_pos, kv_pos, window = _layout(kind, B, Sq, Sk, seed=11)
    want = attend_jax(qj, kj, vj, jnp.asarray(q_pos), jnp.asarray(kv_pos),
                      causal=True, window=window, chunk=64)
    got = ref.flash_decode_split_ref(qt, kt, vt, torch.tensor(q_pos),
                                     torch.tensor(kv_pos), causal=True,
                                     window=window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=BF16_ATOL,
                               rtol=BF16_ATOL)


@pytest.mark.parametrize("kind", ["prefill", "ring", "dead"])
@pytest.mark.parametrize("Hq,Hkv,D", [(8, 2, 64), (4, 4, 16), (4, 2, 120)])
def test_attend_tc_ref_matches_reference(kind, Hq, Hkv, D):
    """The wgmma prefill's algorithm on values bf16 holds exactly, against
    the reference's attend_full_ref in float32, at TC_ATOL."""
    B, Sq, Sk = 2, 40, 150
    q, k, v = map(_bf16_values, _normal(
        12, (B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
    q_pos, kv_pos, window = _layout(kind, B, Sq, Sk, seed=13)
    want = attend_full_jax(*map(jnp.asarray, (q, k, v, q_pos, kv_pos)),
                           causal=True, window=window)
    got = ref.attend_tc_ref(*map(torch.tensor, (q, k, v, q_pos, kv_pos)),
                            causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TC_ATOL,
                               rtol=TC_ATOL)


def test_single_bf16_pass_of_p_is_another_result():
    """One bf16 pass of P (p_dtype=bfloat16) moves the output well past
    TC_ATOL where P_hi + P_lo stays inside it: the split is what keeps the
    tensor cores' answer the reference's."""
    B, Sq, Sk, Hq, Hkv, D = 2, 64, 256, 8, 2, 64
    q, k, v = map(_bf16_values, _normal(
        14, (B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
    q_pos, kv_pos, _ = _layout("prefill", B, Sq, Sk, seed=15)
    args = tuple(map(torch.tensor, (q, k, v, q_pos, kv_pos)))
    want = ref.attend_full_ref(*args).numpy()
    two = np.abs(ref.attend_tc_ref(*args).numpy() - want).max()
    one = np.abs(ref.attend_tc_ref(*args, p_dtype=torch.bfloat16).numpy()
                 - want).max()
    assert two < TC_ATOL < one


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (False, 0)])
def test_attend_tc_ref_matches_pallas_kernel(causal, window):
    """At arange positions, the reference's Pallas kernel in interpret mode
    on the same bf16 values, in float32."""
    B, H, S, D = 2, 2, 130, 32
    q, k, v = map(_bf16_values, _normal(16, *[(B, H, S, D)] * 3))
    want = pallas_fa(*map(jnp.asarray, (q, k, v)), causal=causal,
                     window=window, block_q=64, block_k=64, interpret=True)
    qt, kt, vt = (torch.tensor(a).transpose(1, 2) for a in (q, k, v))
    pos = ref.arange_positions(B, S, "cpu")
    got = ref.attend_tc_ref(qt, kt, vt, pos, pos, causal=causal,
                            window=window)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want),
                               atol=TC_ATOL, rtol=TC_ATOL)


# the two uses of #6 the encoder-decoder and the VLM bring, small: (B, Sq,
# Sk, Hq, Hkv, D, causal).  PaliGemma's MQA at D = 256 (G = 8, causal), and
# cross attention (not causal, every query at position 0, Sq != Sk)
NEW_USES = {"mqa_d256": (2, 40, 40, 8, 1, 256, True),
            "cross": (2, 24, 70, 4, 4, 32, False)}


@pytest.mark.parametrize("use", NEW_USES)
def test_new_uses_match_pallas_kernel(use):
    """The reference's Pallas kernel in interpret mode (MHA layout, KV
    heads repeated for GQA) against the plain version, the chunked
    ``attend``, the split decode's algorithm and, on values bf16 holds,
    the wgmma prefill's, each over explicit positions: arange (causal) or
    queries at 0 against arange keys (not causal)."""
    B, Sq, Sk, Hq, Hkv, D, causal = NEW_USES[use]
    G = Hq // Hkv
    q, k, v = map(_bf16_values, _normal(
        21, (B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D)))
    want = np.asarray(pallas_fa(
        jnp.asarray(q), jnp.asarray(np.repeat(k, G, axis=1)),
        jnp.asarray(np.repeat(v, G, axis=1)), causal=causal, block_q=64,
        block_k=64, interpret=True)).transpose(0, 2, 1, 3)
    qt, kt, vt = (torch.tensor(a).transpose(1, 2).contiguous()
                  for a in (q, k, v))
    q_pos = (ref.arange_positions(B, Sq, "cpu") if causal
             else torch.zeros((B, Sq), dtype=torch.int32))
    kv_pos = ref.arange_positions(B, Sk, "cpu")
    args = (qt, kt, vt, q_pos, kv_pos)
    for got, tol in (
            (ref.attend_full_ref(*args, causal=causal), ATOL),
            (ops.flash_attend(*args, causal=causal), ATOL),
            (attend(*args, causal=causal, chunk=16), ATOL),
            (ref.flash_decode_split_ref(*args, causal=causal, split=7), ATOL),
            (ref.attend_tc_ref(*args, causal=causal), TC_ATOL)):
        np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("kind", ["prefill", "ring", "dead"])
def test_attend_tc_ref_bf16_matches_reference(kind):
    """bf16 inputs and output against the reference's attend in bf16."""
    B, Sq, Sk, Hq, Hkv, D = 2, 40, 150, 8, 2, 32
    arrays = _normal(17, (B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, "bfloat16") for a in arrays)
    q_pos, kv_pos, window = _layout(kind, B, Sq, Sk, seed=18)
    want = attend_jax(qj, kj, vj, jnp.asarray(q_pos), jnp.asarray(kv_pos),
                      causal=True, window=window, chunk=64)
    got = ref.attend_tc_ref(qt, kt, vt, torch.tensor(q_pos),
                            torch.tensor(kv_pos), causal=True, window=window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=BF16_ATOL,
                               rtol=BF16_ATOL)


@pytest.mark.parametrize("which", ["tc", "split", "flash_attend"])
def test_p_dtype_bf16_matches_reference(which):
    """p_dtype=bfloat16 (p and v rounded to bf16, f32 accumulation) against
    the reference's attend(p_dtype=jnp.bfloat16).  The wgmma prefill's
    algorithm rounds p where the reference's scan does (exp(s - running
    max) of each 64-key chunk), but exp differs in its last bits between
    XLA and PyTorch, so the few p that lie at a bf16 rounding boundary
    round the other way: held at 1e-3.  The split decode rounds exp(s -
    its split's max) and the plain path the normalized p, so those may
    differ from the reference by one bf16 rounding of every p (2^-9
    relative): |do| <= 2^-8 max|v| ~ 1.6e-2 at the most, held at 1e-2."""
    B, Sq, Sk, Hq, Hkv, D = 2, 24, 150, 8, 2, 32
    q, k, v = map(_bf16_values, _normal(
        19, (B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
    q_pos, kv_pos, _ = _layout("prefill", B, Sq, Sk, seed=20)
    want = attend_jax(*map(jnp.asarray, (q, k, v, q_pos, kv_pos)),
                      causal=True, chunk=64, p_dtype=jnp.bfloat16)
    args = tuple(map(torch.tensor, (q, k, v, q_pos, kv_pos)))
    fn, tol = {
        "tc": (ref.attend_tc_ref, 1e-3),
        "split": (ref.flash_decode_split_ref, BF16_ATOL),
        "flash_attend": (ops.flash_attend, BF16_ATOL)}[which]
    got = fn(*args, p_dtype=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("Sq,Hq,Hkv,D,dtype,want", [
    (1, 32, 4, 64, torch.bfloat16, "decode_split"),  # tinyllama's step
    (1, 32, 32, 64, torch.float32, "decode_split"),  # zamba2's, float32
    (8, 16, 2, 32, torch.bfloat16, "decode_split"),  # 64 rows exactly
    (65, 4, 4, 32, torch.bfloat16, "prefill_wgmma"),  # 65 rows
    (65, 4, 4, 32, torch.float32, "simt"),
    (512, 32, 4, 64, torch.bfloat16, "prefill_wgmma"),  # the prefills
    (512, 32, 32, 64, torch.bfloat16, "prefill_wgmma"),
    (512, 32, 4, 64, torch.float32, "simt"),  # the float32 parity run
    (200, 16, 2, 120, torch.bfloat16, "prefill_wgmma"),  # D % 8 == 0
    (200, 16, 2, 20, torch.bfloat16, "simt"),  # D % 8 != 0
    (3, 60, 1, 20, torch.bfloat16, "simt"),  # 180 rows, D % 8 != 0
    # a decode step whose rows are not 16-byte multiples
    (1, 60, 1, 20, torch.bfloat16, "simt"),
    (1, 32, 32, 6, torch.float32, "simt"),
    (1, 32, 32, 4, torch.float32, "decode_split"),  # 16-byte rows
    (1, 32, 4, 8, torch.bfloat16, "decode_split"),
    (1, 32, 32, 128, torch.float32, "decode_split"),
    # the encoder-decoder's and the VLM's: seamless's encoder and cross
    # attentions (MHA, D = 64), paligemma's MQA at D = 256
    (1024, 16, 16, 64, torch.bfloat16, "prefill_wgmma"),
    (1, 16, 16, 64, torch.float32, "decode_split"),
    (768, 8, 1, 256, torch.bfloat16, "prefill_wgmma"),
    (768, 8, 1, 256, torch.float32, "simt"),
    (1, 8, 1, 256, torch.bfloat16, "decode_split"),
    (1, 8, 1, 256, torch.float32, "decode_split"),
])
def test_kernel_for_follows_the_dispatch_table(Sq, Hq, Hkv, D, dtype, want):
    assert kernel.kernel_for(Sq, Hq, Hkv, D, dtype) == want


def test_decode_scratch_covers_every_row_and_split():
    """(m, l, acc[D]) for each (batch, query, head) row and 64-key split;
    one split when there is no key."""
    assert kernel.decode_scratch_numel(4, 1, 544, 32, 4, 64) == (
        4 * 32 * 9 * 66)
    assert kernel.decode_scratch_numel(2, 1, 0, 8, 2, 16) == 2 * 8 * 18
    # paligemma's last decode step: 13 splits of 800 slots, D = 256
    assert kernel.decode_scratch_numel(4, 1, 800, 8, 1, 256) == (
        4 * 8 * 13 * 258)


@pytest.mark.parametrize("which", ["simt", "prefill_wgmma", "decode_split"])
def test_named_kernel_entry_refuses_cpu_tensors(which):
    """``kernel._launch`` (chip_smoke.py's entry to one named kernel) checks
    its inputs as ``flash_attention`` does: a CPU tensor never reaches a
    launch, and nothing is counted."""
    q = torch.zeros(1, 4, 4, 16, dtype=torch.bfloat16)
    kv = torch.zeros(1, 4, 2, 16, dtype=torch.bfloat16)
    pos = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        kernel._launch(q, kv, kv, pos, pos, kernel=which)
    assert kernel.flash_attention.launches_by_kernel == dict.fromkeys(
        kernel.KERNELS, 0)
