"""#6's backward on the CPU, held to the JAX package.

The reference trains through XLA's autodiff of its chunked scan
(``src/repro/models/attention.py: attend``); its Pallas flash kernel has no
backward.  The port's backward is two CUDA kernels
(``kernel.flash_attention_backward``, ``csrc/flash_backward.cu``), run and
held to their plain version only on the card (``chip_smoke.py`` phase 19).
Here, at reduced versions of phase 19's shapes (GQA, MHA not causal, MQA
at D = 256, a window shorter than S, cross attention with Sq != Sk,
unwritten slots and a fully masked row):

- ``ref.flash_attend_bwd_ref``, the closed form the kernels are held to,
  against ``jax.vjp`` of the reference's ``attend``;
- the autograd Function ``ops.FlashAttend``, through its CPU path (the
  oracle's forward, the plain backward), against the same, from views
  after a reshape and a transpose as the model hands them over;
- that a no-grad call, or one whose inputs need no grad, saves nothing,
  that ``p_dtype`` bfloat16 is refused under grad, and that the kernel's
  wrapper refuses a CPU tensor.

Tolerance: float32 on both sides, 2e-5 absolute and relative (the sums'
order; the gradients are O(1)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import attend as attend_ref
from repro_torch.kernels.flash_attention import kernel, ops, ref
from repro_torch.models.attention import attend

TOL = 2e-5

# label -> ((B, Sq, Sk, Hq, Hkv, D), causal, window, positions' kind)
SHAPES = {
    "gqa causal": ((2, 40, 40, 8, 2, 16), True, 0, "arange"),
    "window": ((2, 48, 48, 8, 2, 24), True, 16, "arange"),
    "mha not causal": ((2, 24, 24, 4, 4, 16), False, 0, "arange"),
    "cross sq != sk": ((2, 8, 40, 4, 4, 16), False, 0, "cross"),
    "mqa d256": ((1, 20, 20, 8, 1, 256), True, 0, "arange"),
    "holes, a dead row": ((2, 30, 30, 4, 2, 16), True, 0, "holes_dead"),
}


def case(shape, kind, seed=0):
    """q, k, v, dO (standard normal, float32) and int32 positions, numpy."""
    B, Sq, Sk, Hq, Hkv, D = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    q_pos = np.tile(np.arange(Sk - Sq, Sk, dtype=np.int32), (B, 1))
    kv_pos = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    if kind == "cross":
        q_pos[:] = 0
    elif kind == "holes_dead":
        kv_pos[:, ::7] = -1
        kv_pos[1, :10] = -1
        q_pos[0, 0] = -1  # before every slot: attends nothing
    return q, k, v, do, q_pos, kv_pos


def reference_grads(q, k, v, do, q_pos, kv_pos, causal, window):
    """(o, dq, dk, dv) of the reference's chunked ``attend`` by
    ``jax.vjp``, chunk 16 (several chunks a row)."""
    def f(q_, k_, v_):
        return attend_ref(q_, k_, v_, jnp.asarray(q_pos), jnp.asarray(kv_pos),
                          causal=causal, window=window, chunk=16)
    o, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return (o, *vjp(jnp.asarray(do)))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("label", SHAPES)
def test_plain_backward_matches_jax_vjp(label):
    shape, causal, window, kind = SHAPES[label]
    q, k, v, do, q_pos, kv_pos = case(shape, kind)
    o_ref, *want = reference_grads(q, k, v, do, q_pos, kv_pos, causal, window)
    t = [torch.tensor(x) for x in (q, k, v, do, q_pos, kv_pos)]
    o = ref.attend_full_ref(t[0], t[1], t[2], t[4], t[5], causal=causal,
                            window=window)
    close(o, o_ref)
    got = ref.flash_attend_bwd_ref(t[0], t[1], t[2], o, t[3], t[4], t[5],
                                   causal=causal, window=window)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == t[("dq", "dk", "dv").index(name)].shape, name
        close(g, w)
    dead = ~ref.position_mask(t[4], t[5], causal, window).any(-1)
    assert bool(dead.any()) == (kind == "holes_dead")
    assert bool((got[0][dead] == 0).all())


@pytest.mark.parametrize("label", SHAPES)
def test_function_cpu_path_matches_jax_vjp(label):
    """``flash_attend`` under grad goes through ``FlashAttend`` (its CPU
    path); q arrives as the (B, S, H*D) projection reshaped and k, v as
    transposed copies, views as the model hands them over."""
    shape, causal, window, kind = SHAPES[label]
    q, k, v, do, q_pos, kv_pos = case(shape, kind, seed=1)
    o_ref, *want = reference_grads(q, k, v, do, q_pos, kv_pos, causal, window)
    B, Sq, Hq, D = q.shape
    q_flat = torch.tensor(q.reshape(B, Sq, Hq * D), requires_grad=True)
    k_t = torch.tensor(k.transpose(0, 2, 1, 3).copy(), requires_grad=True)
    v_t = torch.tensor(v.transpose(0, 2, 1, 3).copy(), requires_grad=True)
    qq, kk, vv = (q_flat.view(B, Sq, Hq, D), k_t.transpose(1, 2),
                  v_t.transpose(1, 2))
    assert not kk.is_contiguous() or k.shape[2] == 1  # MQA: one head
    o = ops.flash_attend(qq, kk, vv, torch.tensor(q_pos),
                         torch.tensor(kv_pos), causal=causal, window=window)
    assert type(o.grad_fn).__name__ == "FlashAttendBackward"
    close(o, o_ref)
    dq, dk_t, dv_t = torch.autograd.grad(o, (q_flat, k_t, v_t),
                                         torch.tensor(do))
    close(dq.view(B, Sq, Hq, D), want[0])
    close(dk_t.transpose(1, 2), want[1])
    close(dv_t.transpose(1, 2), want[2])


def test_bf16_inputs_give_bf16_gradients():
    shape, causal, window, kind = SHAPES["gqa causal"]
    q, k, v, do, q_pos, kv_pos = case(shape, kind, seed=2)
    t = [torch.tensor(x, dtype=torch.bfloat16, requires_grad=True)
         for x in (q, k, v)]
    o = ops.flash_attend(*t, torch.tensor(q_pos), torch.tensor(kv_pos))
    grads = torch.autograd.grad(o, t, torch.tensor(do, dtype=torch.bfloat16))
    assert o.dtype == torch.bfloat16
    assert all(g.dtype == torch.bfloat16 for g in grads)
    # the same gradients as the float32 closed form on the bf16 inputs,
    # within one bf16 rounding
    tf = [x.detach().float() for x in t]
    want = ref.flash_attend_bwd_ref(
        *tf, o.float(), torch.tensor(do, dtype=torch.bfloat16).float(),
        torch.tensor(q_pos), torch.tensor(kv_pos))
    for g, w in zip(grads, want):
        assert bool(((g.float() - w).abs()
                     <= 2.0**-8 * w.abs() + 1e-6).all())


def test_no_grad_calls_save_nothing():
    shape, causal, window, kind = SHAPES["gqa causal"]
    q, k, v, _, q_pos, kv_pos = case(shape, kind)
    pos = (torch.tensor(q_pos), torch.tensor(kv_pos))
    t = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    with torch.no_grad():
        assert ops.flash_attend(*t, *pos).grad_fn is None
        assert attend(*t, *pos).grad_fn is None
    plain = [x.detach() for x in t]
    assert ops.flash_attend(*plain, *pos).grad_fn is None
    # the chunked scan on the CPU is the model's attend, differentiated by
    # autograd as the reference's scan is by XLA
    assert attend(*t, *pos).grad_fn is not None


def test_p_bf16_refused_under_grad():
    shape, causal, window, kind = SHAPES["gqa causal"]
    q, k, v, _, q_pos, kv_pos = case(shape, kind)
    pos = (torch.tensor(q_pos), torch.tensor(kv_pos))
    t = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    with pytest.raises(ValueError, match="p_dtype bfloat16 has no backward"):
        ops.flash_attend(*t, *pos, p_dtype=torch.bfloat16)
    with torch.no_grad():
        out = ops.flash_attend(*t, *pos, p_dtype=torch.bfloat16)
    assert out.shape == t[0].shape


def test_backward_wrapper_refuses_cpu_and_bad_inputs():
    shape, _, _, kind = SHAPES["gqa causal"]
    q, k, v, do, q_pos, kv_pos = (torch.tensor(x) for x in case(shape, kind))
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.flash_attention_backward(q, k, v, q, do, q_pos, kv_pos)
    with pytest.raises(ValueError, match="shapes"):
        kernel.flash_attention_backward(q, k[:, :3], v, q, do, q_pos, kv_pos)
    assert kernel.BWD_KERNELS == ("bwd_dq", "bwd_dkdv", "bwd_dq_wgmma",
                                  "bwd_dkdv_wgmma")
    assert set(kernel.flash_attention_backward.launches_by_kernel) == set(
        kernel.BWD_KERNELS)
    assert kernel.BWD_SOURCE in kernel.LIBRARIES["flash_backward"]
    assert kernel.BWD_WGMMA_SOURCE in kernel.LIBRARIES["flash_backward"]
