"""The port's int8 model sync against the reference's, on the same numpy
inputs: quantization bit for bit, the int8 matmul's plain version against
the reference's Pallas kernel (interpret mode), the int8 forward, and the
checksums and byte counts of the sync protocol.

The CUDA kernel itself runs only on a card, and the card's machine has no JAX
for this suite: ``chip_smoke.py`` holds the kernel to the plain version there.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_ref
from repro.kernels.int8_matmul.kernel import int8_matmul as jax_int8_matmul
from repro.kernels.int8_matmul.ops import qmatmul as jax_qmatmul
from repro.models import lstm as lstm_ref
from repro.runtime.executor import _nbytes as jax_nbytes
from repro.runtime.faults import tree_checksum as jax_tree_checksum
from repro.serving import quantize as quantize_ref
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.int8_matmul import kernel as int8_kernel
from repro_torch.kernels.int8_matmul.ops import qmatmul
from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref
from repro_torch.models import lstm
from repro_torch.runtime.executor import _nbytes
from repro_torch.serving import quantize
from repro_torch.serving.quantize import tree_checksum

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


def _random_tree(seed):
    """A nested dict of float32 leaves of several ranks and sizes: some
    quantize at min_size=64, some stay float."""
    rng = np.random.default_rng(seed)
    scale = float(rng.uniform(0.1, 10.0))
    return {
        "b": {"w": (rng.normal(size=(16, 24)) * scale).astype(np.float32),
              "bias": rng.normal(size=(24,)).astype(np.float32)},
        "a": {"small": rng.normal(size=(4, 8)).astype(np.float32),
              "deep": rng.normal(size=(3, 5, 7)).astype(np.float32),
              "zero": np.zeros((8, 8), np.float32)},
    }


def _fixture_models():
    fx = smoke.load_fixture()
    return [smoke.unflatten(fx, f"speed{t}")
            for t in range(int(fx["n_speed_models"]))]


def _to_port(tree):
    return params_from_numpy(tree, "cpu")


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _pairs(port_tree, ref_tree):
    """(port leaf, reference leaf) by key, a QTensor on both sides or
    neither."""
    for k in sorted(ref_tree):
        if isinstance(ref_tree[k], dict):
            yield from _pairs(port_tree[k], ref_tree[k])
        else:
            yield k, port_tree[k], ref_tree[k]


TREES = ([("random", s, lambda s=s: _random_tree(s)) for s in range(4)]
         + [("fixture", t, lambda t=t: _fixture_models()[t]) for t in (0, 5)])


@pytest.mark.parametrize("kind,index,make", TREES,
                         ids=[f"{k}{i}" for k, i, _ in TREES])
def test_quantize_tree_bit_exact_with_reference(kind, index, make):
    """q and scale equal the reference's bit for bit, leaf for leaf, and the
    same leaves stay float; dequantize_tree agrees exactly too."""
    tree = make()
    ours = quantize.quantize_tree(_to_port(tree), min_size=64)
    ref = quantize_ref.quantize_tree(_to_jax(tree), min_size=64)
    n_quantized = 0
    for k, got, want in _pairs(ours, ref):
        assert isinstance(got, quantize.QTensor) == isinstance(
            want, quantize_ref.QTensor), k
        if isinstance(want, quantize_ref.QTensor):
            n_quantized += 1
            assert got.q.dtype == torch.int8
            assert got.orig_dtype == want.orig_dtype
            np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
            np.testing.assert_array_equal(
                got.scale.numpy().view(np.uint32),
                np.asarray(want.scale).view(np.uint32))
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert n_quantized == 3
    for k, got, want in _pairs(quantize.dequantize_tree(ours),
                               quantize_ref.dequantize_tree(ref)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lstm_paper_sync_sizes():
    """lstm/kernel (5x160), lstm/recurrent (40x160) and dense/dense_w
    (40x10) quantize; 31,124 B float, 9,644 B int8: below the reference's
    0.45x bound (tests/test_executor.py)."""
    model = _to_port(_fixture_models()[0])
    q8 = quantize.quantize_tree(model, min_size=64)
    quantized = {f"{a}/{b}" for a, sub in q8.items() for b, v in sub.items()
                 if isinstance(v, quantize.QTensor)}
    assert quantized == {"lstm/kernel", "lstm/recurrent", "dense/dense_w"}
    assert quantize.tree_nbytes(model) == 31_124
    assert quantize.tree_nbytes(q8) == 9_644 < 0.45 * 31_124
    assert _nbytes(q8) == 9_644.0


@pytest.mark.parametrize("make", [lambda: _random_tree(7),
                                  lambda: _fixture_models()[2]])
def test_checksum_and_byte_counts_equal_reference(make):
    tree = make()
    for quantized in (False, True):
        ours, ref = _to_port(tree), _to_jax(tree)
        if quantized:
            ours = quantize.quantize_tree(ours, min_size=64)
            ref = quantize_ref.quantize_tree(ref, min_size=64)
        assert tree_checksum(ours) == jax_tree_checksum(ref)
        assert quantize.tree_nbytes(ours) == quantize_ref.tree_nbytes(ref)
        assert _nbytes(ours) == jax_nbytes(ref)


def test_checksum_sees_one_flipped_bit():
    q8 = quantize.quantize_tree(_to_port(_fixture_models()[1]), min_size=64)
    before = tree_checksum(q8)
    qt = q8["lstm"]["recurrent"]
    flipped = qt.q.clone()
    flipped.view(torch.uint8)[7, 3] ^= 0x10
    q8["lstm"]["recurrent"] = quantize.QTensor(flipped, qt.scale,
                                               qt.orig_dtype)
    assert tree_checksum(q8) != before
    q8["lstm"]["recurrent"] = qt
    assert tree_checksum(q8) == before


@pytest.mark.parametrize("seed", range(3))
def test_dequantize_round_trip_bound(seed):
    """As the reference's tests/test_quantize.py: error at most scale/2 =
    amax/254 per column, and below one int8 step of the largest value."""
    w = np.random.default_rng(seed).normal(size=(64, 128)).astype(
        np.float32) * (seed + 1)
    qt = quantize.quantize(torch.from_numpy(w))
    back = quantize.dequantize(qt).numpy()
    amax = np.abs(w).max(axis=0)
    assert (np.abs(back - w) <= amax[None] / 254 + 1e-7).all()
    assert np.abs(back - w).max() / np.abs(w).max() < 1 / 120
    assert qt.q.dtype == torch.int8 and qt.scale.shape == (128,)


def _mm_inputs(M, K, N, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    q = rng.integers(-127, 128, size=(K, N)).astype(np.int8)
    s = (np.abs(rng.normal(size=(N,))) * 0.01).astype(np.float32)
    return x, q, s


# the reference's sweep shapes (tests/test_kernels.py) and the bus path's
MM_SHAPES = [(64, 128, 96), (33, 100, 17), (1, 40, 160), (128, 512, 128),
             (1250, 5, 160), (250, 40, 160), (250, 40, 10)]


@pytest.mark.parametrize("M,K,N", MM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_pallas_kernel(M, K, N, dtype):
    """float32: atol = rtol = 1e-5 at K <= 40, the reference's own 1e-3
    above (blocked K sums in another order).  bf16 x: within one bf16 step
    of the value, as both round one float32 result."""
    x, q, s = _mm_inputs(M, K, N, dtype, seed=M + K + N)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = int8_matmul_ref(xt, torch.from_numpy(q), torch.from_numpy(s))
    want = jax_int8_matmul(xj, jnp.asarray(q), jnp.asarray(s),
                           interpret=True)
    assert got.dtype == xt.dtype and got.shape == (M, N)
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "float32":
        tol = 1e-5 if K <= 40 else 1e-3
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    else:
        np.testing.assert_array_less(np.abs(got - want),
                                     2.0**-7 * np.abs(want) + 1e-5)


def test_qmatmul_flattens_leading_dims_like_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64, 32)).astype(np.float32)
    got = qmatmul(torch.from_numpy(x), quantize.quantize(torch.from_numpy(w)))
    want = jax_qmatmul(jnp.asarray(x), quantize_ref.quantize(jnp.asarray(w)),
                       interpret=True)
    assert got.shape == (4, 5, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert int8_kernel.int8_matmul.launches == 0


@pytest.mark.parametrize("t", [0, 3])
def test_forward_int8_matches_reference(t):
    """The port's _forward_int8 and the reference's forward (through
    qmatmul in interpret mode) on the same int8 tree and window: atol
    1e-5; and the fixture's int8pred{t} too."""
    fx = smoke.load_fixture()
    model = smoke.unflatten(fx, f"speed{t}")
    x = smoke.port_stream(smoke.unflatten(fx, "setup")).supervised(t + 1)["x"]
    ours = quantize.quantize_tree(_to_port(model), min_size=64)
    with torch.inference_mode():
        got = lstm.forward(get_config("lstm-paper"), ours,
                           torch.from_numpy(x)).numpy()
    want = np.asarray(lstm_ref.forward(
        get_config_ref("lstm-paper"),
        quantize_ref.quantize_tree(_to_jax(model), min_size=64),
        jnp.asarray(x)))
    assert got.shape == want.shape == (len(x), 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, fx[f"int8pred{t}"], rtol=0, atol=1e-5)


def test_wrapper_rejects_cpu_tensors_and_bad_inputs():
    x, q, s = map(torch.from_numpy, _mm_inputs(4, 8, 6, "float32", 0))
    with pytest.raises(ValueError, match="one CUDA device"):
        int8_kernel.int8_matmul(x, q, s)
    with pytest.raises(ValueError, match="do not match"):
        int8_kernel.int8_matmul(x, q[:-1], s)
    with pytest.raises(TypeError, match="q must be int8"):
        int8_kernel.int8_matmul(x, q.float(), s)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        int8_kernel.int8_matmul(x.double(), q, s)
    # on meta (the dry run's trace) the meta operator stands in: the
    # kernel's shape, no launch
    y = qmatmul(x.to("meta"), quantize.QTensor(q.to("meta"), s.to("meta"),
                                               "float32"))
    assert y.device.type == "meta" and y.shape == (4, 6)
    assert int8_kernel.int8_matmul.launches == 0
