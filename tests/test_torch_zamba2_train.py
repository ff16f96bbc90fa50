"""The Zamba2 hybrid's training on the CPU, held to the JAX package.

The plain reverse recurrence ``ref.selective_scan_bwd_ref`` and
``ops.SelectiveScan``'s CPU path (the gradient the port takes through
``ops.selective_scan`` under grad) against ``jax.vjp`` of the reference's
``models/ssm.py: ssd_stepwise`` plus the skip D and of its oracle
``kernels/ssm_scan/ref.py: ssm_scan_ref`` (b and c broadcast to every
head, as its ``ops.selective_scan`` does), from a zero state and from a
nonzero one, with and without a final state's cotangent, decays that
round to 0; ``loss_fn``'s loss, metrics and every gradient leaf of
``zamba2-1.2b`` at ``reduced()`` (2 layers, the shared block after each)
and at 3 layers with ``attn_every=2`` (one super-layer and a one-layer
tail), the reference's params carried across by ``convert``, against
``jax.value_and_grad`` of the reference's ``loss_fn``; ``remat`` "block"
equal to "none"; what the wrappers refuse; the phase-20 (b) fixture's
format, and a reduced regeneration reproduced by
``chip_smoke.run_train_parity`` on the CPU.

Tolerances, those of ``tests/test_torch_zoo_train.py``: float32 on
both sides; a loss within 1e-5, a gradient leaf within 1e-4 of that
leaf's largest |gradient| (the sums' order through the layers and their
backward); a scan's gradient within 1e-5 of its largest |value|.

The card has no JAX, so phase 20 (b) of ``chip_smoke.py`` reads the
reference's float32 training of ``zamba2-1.2b`` at full width, cut to 8
layers (one super-layer of 6 and the 2-layer tail), from
``tests/data/torch_parity_train_zamba2_1_2b.npz``.  Rewrite it with

    PYTHONPATH=src python tests/test_torch_zamba2_train.py
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_ref
from repro.kernels.ssm_scan import ref as kernel_ref_jax
from repro.models import ssm as ssm_ref
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.ssm_scan import kernel, ops, ref
from repro_torch.models import hybrid_arch
from repro_torch.models.model import get_model
from repro_torch.training.optimizer import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "rwkv_train", ROOT / "tests" / "test_torch_rwkv_train.py")
rwkv_train = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(rwkv_train)
smoke = rwkv_train.smoke

ARCH = smoke.ZAMBA_ARCH
SCAN_RTOL = rwkv_train.SCAN_RTOL
GRADS = ("dx", "db", "dc", "ddt", "da", "dd", "dstate0")


def _configs(n_layers=0, attn_every=0, **kw):
    """The reference's and the port's reduced config, at ``n_layers`` and
    ``attn_every`` where given, then ``kw``."""
    out = []
    for cfg in (get_config_ref(ARCH).reduced(), get_config(ARCH).reduced()):
        if n_layers:
            cfg = cfg.replace(n_layers=n_layers, hybrid=dataclasses.replace(
                cfg.hybrid, attn_every=attn_every))
        out.append(cfg.replace(**kw))
    return tuple(out)


# -- the scan's gradient -----------------------------------------------------


def _scan_inputs(B=2, T=11, H=3, P=5, N=4, seed=0, dt_scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    b, c = (rng.standard_normal((B, T, N)).astype(np.float32) * 0.3
            for _ in range(2))
    dt = (np.log1p(np.exp(rng.standard_normal((B, T, H)))) * dt_scale
          ).astype(np.float32)
    a = -np.exp(rng.standard_normal(H)).astype(np.float32)
    d = rng.standard_normal(H).astype(np.float32)
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    dy = rng.standard_normal((B, T, H, P)).astype(np.float32)
    ds = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return x, b, c, dt, a, d, s0, dy, ds


def _stepwise(x, b, c, dt, a, d, s0):
    """The reference's model path: ``ssd_stepwise`` plus the skip."""
    y, h = ssm_ref.ssd_stepwise(x, b, c, dt, a, s0)
    return y + d[None, None, :, None] * x, h


def _flat_oracle(x, b, c, dt, a, d, s0):
    """The reference's oracle (flat layout, b and c broadcast to every
    head) in the model layout."""
    B, T, H, P = x.shape
    N = b.shape[-1]
    y, s = kernel_ref_jax.ssm_scan_ref(
        x.transpose(0, 2, 1, 3).reshape(B * H, T, P),
        jnp.broadcast_to(b[:, None], (B, H, T, N)).reshape(B * H, T, N),
        jnp.broadcast_to(c[:, None], (B, H, T, N)).reshape(B * H, T, N),
        dt.transpose(0, 2, 1).reshape(B * H, T),
        jnp.broadcast_to(a[None], (B, H)).reshape(B * H),
        jnp.broadcast_to(d[None], (B, H)).reshape(B * H),
        s0.reshape(B * H, P, N))
    return (y.reshape(B, H, T, P).transpose(0, 2, 1, 3),
            s.reshape(B, H, P, N))


def _reference_vjp(fn, arrays, dy, ds):
    _, vjp = jax.vjp(fn, *map(jnp.asarray, arrays))
    return vjp((jnp.asarray(dy), jnp.asarray(
        np.zeros(arrays[-1].shape, np.float32) if ds is None else ds)))


@pytest.mark.parametrize("oracle", ["ssd_stepwise", "ssm_scan_ref"])
@pytest.mark.parametrize("state, dstate", [(True, True), (False, False),
                                           (True, False), (False, True)])
def test_selective_scan_bwd_ref_matches_reference_vjp(oracle, state,
                                                      dstate):
    x, b, c, dt, a, d, s0, dy, ds = _scan_inputs(seed=3)
    s0 = s0 if state else np.zeros_like(s0)
    ds = ds if dstate else None
    fn = _stepwise if oracle == "ssd_stepwise" else _flat_oracle
    want = _reference_vjp(fn, (x, b, c, dt, a, d, s0), dy, ds)
    got = ref.selective_scan_bwd_ref(
        *(torch.tensor(t) for t in (x, b, c, dt, a, d)),
        torch.tensor(s0) if state else None, torch.tensor(dy),
        None if ds is None else torch.tensor(ds))
    for name, g, w in zip(GRADS, got, want):
        rwkv_train.close_leaf(g, w, SCAN_RTOL, name)


@pytest.mark.parametrize("dt_scale", [1.0, 40.0])
def test_selective_scan_function_cpu_path_matches_reference_vjp(dt_scale):
    """``ops.selective_scan`` under grad (``SelectiveScan`` with the plain
    backward) against ``jax.vjp`` of the reference's path; dt x 40 makes
    decays that round to 0."""
    arrays = _scan_inputs(T=29, P=8, N=16, seed=5, dt_scale=dt_scale)
    x, b, c, dt, a, d, s0, dy, ds = arrays
    if dt_scale > 1:
        assert (np.exp(dt * a) == 0).any()
    want = _reference_vjp(_stepwise, arrays[:7], dy, ds)
    leaves = [torch.tensor(t, requires_grad=True) for t in arrays[:7]]
    y, s = ops.selective_scan(*leaves)
    assert type(y.grad_fn).__name__ == "SelectiveScanBackward"
    got = torch.autograd.grad((y * torch.tensor(dy)).sum()
                              + (s * torch.tensor(ds)).sum(), leaves)
    for name, g, w in zip(GRADS, got, want):
        rwkv_train.close_leaf(g, w, SCAN_RTOL, name)
    with torch.no_grad():
        y0, s_0 = ops.selective_scan(*(t.detach() for t in leaves))
    assert torch.equal(y.detach(), y0) and torch.equal(s.detach(), s_0)
    # from no state: the gradient has no slot for one
    y, _ = ops.selective_scan(*leaves[:6])
    got = torch.autograd.grad((y * torch.tensor(dy)).sum(), leaves[:6])
    want = _reference_vjp(_stepwise, (*arrays[:6], np.zeros_like(s0)), dy,
                          None)
    for name, g, w in zip(GRADS, got, want):
        rwkv_train.close_leaf(g, w, SCAN_RTOL, name)


def test_wrappers_refuse_what_has_no_gradient():
    x, b, c, dt, a, d, s0, dy, ds = (torch.tensor(t) for t in _scan_inputs())
    live = x.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="out= has no gradient"):
        ops.selective_scan(live, b, c, dt, a, d, s0,
                           out=torch.empty_like(s0))
    with torch.no_grad():
        out = torch.empty_like(s0)
        y, s = ops.selective_scan(live, b, c, dt, a, d, s0, out=out)
    assert s is out and y.grad_fn is None
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.ssm_scan_backward(x, b, c, dt, a, d, s0, dy, ds)
    with pytest.raises(TypeError, match="float32"):
        kernel.ssm_scan_backward(x, b, c, dt, a, d, s0, dy.double(), ds)
    with pytest.raises(ValueError, match="dy must be"):
        kernel.ssm_scan_backward(x, b, c, dt, a, d, s0, dy[:, :1], ds)
    with pytest.raises(ValueError, match="dstate must be"):
        kernel.ssm_scan_backward(x, b, c, dt, a, d, s0, dy, ds[..., :1])
    assert kernel.ssm_scan_backward.launches == 0
    # two kernels a call, in this order: the boundary pass, the chunks
    assert list(kernel.BWD_KERNELS) == ["bounds", "chunk"]
    assert kernel.ssm_scan_backward.launches_by_kernel == {"bounds": 0,
                                                           "chunk": 0}
    assert kernel.LIBRARIES["ssm_backward"] == [kernel.BWD_SOURCE]


# -- the model's loss and gradients -------------------------------------------


@pytest.mark.parametrize("layers", [(0, 0), (3, 2)])
def test_loss_and_gradients_match_reference(layers):
    cfg_ref, cfg = _configs(*layers)
    k, n_super, rem = hybrid_arch._split(cfg)
    assert rem == (1 if layers[0] else 0)  # (3, 2): the one-layer tail
    rwkv_train.check_loss_and_gradients(cfg_ref, cfg)


def test_remat_block_equals_none_and_forward_matches_no_grad():
    _, cfg = _configs(3, 2)
    p = params_from_numpy(smoke.numpy_params(cfg, 1), "cpu")
    b = {k: torch.as_tensor(v) for k, v in smoke.train_batch(
        cfg, 1, (2, 20)).items()}
    loss, _, g = rwkv_train.port_grads(get_model(cfg), p, b)
    loss_r, _, g_r = rwkv_train.port_grads(
        get_model(cfg.replace(remat="block")), p, b)
    assert torch.equal(loss_r, loss)
    for x, y in zip(tree_leaves(g_r), tree_leaves(g)):
        assert torch.equal(x, y)
    live = tree_map(lambda t: t.detach().requires_grad_(True), p)
    h, states = hybrid_arch.forward(cfg, live, b)
    with torch.no_grad():
        h0, states0 = hybrid_arch.forward(cfg, p, b)
    assert torch.equal(h.detach(), h0)
    for got, want in zip(states, states0):
        assert torch.equal(got.detach(), want)


# -- the phase-20 (b) fixture ----------------------------------------------


def test_committed_train_fixture_is_what_chip_smoke_reads():
    fx = rwkv_train.check_committed_fixture(ARCH, 2048, 8)
    assert fx["norm/mamba/in_proj"].shape == (8,)


def test_reduced_train_fixture_regenerates_and_port_reproduces_it():
    rwkv_train.check_reduced_regeneration(ARCH, "norm/mamba/in_proj")


if __name__ == "__main__":
    import resource
    import time

    t0 = time.perf_counter()
    arrays = rwkv_train.build_train_fixture(ARCH, reduced=False)
    path = smoke.RECURRENT_TRAIN[ARCH][0]
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)
    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"wrote {path} ({path.stat().st_size} bytes) in "
          f"{time.perf_counter() - t0:.1f} s, peak resident {peak_gb:.1f} GB;"
          f" losses {arrays['losses']}, grad norm {arrays['grad_norm']}")
