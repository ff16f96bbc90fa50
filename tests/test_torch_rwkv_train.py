"""RWKV6's training on the CPU, held to the JAX package.

The plain reverse recurrence ``ref.wkv_bwd_ref`` and ``ops.WKV``'s CPU
path (the gradient the port takes through ``ops.wkv`` under grad) against
``jax.vjp`` of the reference's ``models/rwkv.py: wkv_stepwise`` and of its
oracle ``kernels/rwkv6_scan/ref.py: rwkv6_scan_ref``, from a zero state and
from a nonzero one, with and without a final state's cotangent, decays
down to exactly 0; ``loss_fn``'s loss, metrics and every gradient leaf of
``rwkv6-3b`` at ``reduced()`` (2 layers, d_model 256, head size 32), the
reference's params carried across by ``convert``, against
``jax.value_and_grad`` of the reference's ``loss_fn``, per step and with
the chunked CPU scan; ``remat`` "block" equal to "none"; what the wrappers
refuse; the phase-20 (b) fixture's format, and a reduced regeneration
reproduced by ``chip_smoke.run_train_parity`` on the CPU.

Tolerances, those of ``tests/test_torch_zoo_train.py``: float32 on
both sides; a loss within 1e-5, a gradient leaf within 1e-4 of that
leaf's largest |gradient| (the sums' order through two layers and their
backward); a scan's gradient within 1e-5 of its largest |value|.

The card has no JAX, so phase 20 (b) of ``chip_smoke.py`` reads the
reference's float32 training of ``rwkv6-3b`` at full width, cut to 4
layers, from ``tests/data/torch_parity_train_rwkv6_3b.npz`` (seeds and
summaries, no weights).  Rewrite it with

    PYTHONPATH=src python tests/test_torch_rwkv_train.py

(``build_train_fixture`` serves ``tests/test_torch_zamba2_train.py`` too.)
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_ref
from repro.kernels.rwkv6_scan import ref as kernel_ref_jax
from repro.models import get_model as get_model_ref
from repro.models import rwkv as rwkv_ref
from repro.training import adamw as adamw_ref
from repro.training import make_train_step as make_train_step_ref
from repro.training import warmup_cosine as warmup_cosine_ref
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.rwkv6_scan import kernel, ops, ref
from repro_torch.models import rwkv
from repro_torch.models.model import get_model
from repro_torch.training.optimizer import (tree_leaves, tree_map,
                                            tree_unflatten)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

ARCH = smoke.RWKV_ARCH
LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4
SCAN_RTOL = 1e-5


# -- helpers shared with tests/test_torch_zamba2_train.py --------------------


def close_leaf(got, want, rtol=GRAD_RTOL, what=""):
    """``got`` (a tensor) within ``rtol`` of ``want``'s largest |value|."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err} > {rtol} x {scale}"


def port_grads(model, params, batch):
    """(loss, metrics, gradient tree) of ``model.loss_fn`` by autograd."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = model.loss_fn(live, batch)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(live, list(grads)))


def check_loss_and_gradients(cfg_ref, cfg, seed=0, shape=(2, 24)):
    """The port's ``loss_fn`` against ``jax.value_and_grad`` of the
    reference's, params from ``smoke.numpy_params(cfg_ref, seed)``."""
    tree = smoke.numpy_params(cfg_ref, seed)
    b = smoke.train_batch(cfg, seed, shape)
    (loss_ref, met_ref), g_ref = jax.jit(jax.value_and_grad(
        get_model_ref(cfg_ref).loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in b.items()})
    loss, met, g = port_grads(get_model(cfg), params_from_numpy(tree, "cpu"),
                              {k: torch.as_tensor(v) for k, v in b.items()})
    assert abs(float(loss) - float(loss_ref)) <= LOSS_ATOL
    assert sorted(met) == sorted(met_ref)
    for k in met:
        assert abs(float(met[k]) - float(met_ref[k])) <= LOSS_ATOL, k
    got, want = smoke.flat_tree(g), smoke.flat_tree(g_ref)
    assert sorted(got) == sorted(want)
    for path in got:
        close_leaf(got[path], want[path], what=path)
    return g


def to_jax(tree: dict) -> dict:
    """A numpy tree as JAX arrays, emptied leaf by leaf as it goes."""
    out = {}
    for name in list(tree):
        leaf = tree.pop(name)
        out[name] = to_jax(leaf) if isinstance(leaf, dict) else jnp.asarray(
            leaf)
        del leaf
    return out


def build_train_fixture(arch: str, reduced: bool) -> dict:
    """The reference's float32 training of ``arch`` at full width and the
    depth ``smoke.RECURRENT_TRAIN`` names (or ``reduced()``):
    ``smoke.numpy_params`` and ``smoke.train_batch`` from
    ``smoke.TRAIN_SEED``, step 1's loss, xent and gradient summary by
    ``jax.value_and_grad``, then the losses of ``smoke.TRAIN_STEPS`` steps
    of its ``make_train_step`` with adamw(warmup_cosine(*TRAIN_SCHEDULE))."""
    cfg_ref = get_config_ref(arch)
    cfg_ref = (cfg_ref.reduced() if reduced else smoke.zoo_parity_config(
        cfg_ref, smoke.RECURRENT_TRAIN[arch][1]))
    params = to_jax(smoke.numpy_params(cfg_ref, smoke.TRAIN_SEED,
                                       smoke.DRAW_CHUNK))
    batch = {k: jnp.asarray(v) for k, v in smoke.train_batch(
        cfg_ref, smoke.TRAIN_SEED).items()}
    model = get_model_ref(cfg_ref)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        model.loss_fn, has_aux=True))(params, batch)
    run = {"loss": np.float64(float(loss)),
           "xent": np.float64(float(metrics["xent"])),
           **smoke.grad_summary({path: torch.from_numpy(np.array(g))
                                 for path, g in smoke.flat_tree(
                                     grads).items()}, smoke.TRAIN_SEED)}
    del grads
    lr, warmup, total = smoke.TRAIN_SCHEDULE
    opt = adamw_ref(warmup_cosine_ref(lr, warmup, total))
    state = opt.init(params)
    step = jax.jit(make_train_step_ref(model, opt))
    losses = []
    for _ in range(smoke.TRAIN_STEPS):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    run["losses"] = np.array(losses, np.float64)
    return smoke.train_fixture_arrays(arch, reduced, run,
                                      smoke.fixture_cuts(cfg_ref))


def check_committed_fixture(arch: str, d_model: int, n_layers: int):
    """The committed phase-20 (b) fixture of ``arch``: what ``chip_smoke``
    reads, at full width and ``n_layers`` layers."""
    path, depth = smoke.RECURRENT_TRAIN[arch]
    fx = smoke.load_fixture(path)
    assert str(fx["arch"]) == arch and not bool(fx["reduced"])
    assert int(fx["parity_n_layers"]) == depth == n_layers
    assert int(fx["seed"]) == smoke.TRAIN_SEED
    assert int(fx["draw_chunk"]) == smoke.DRAW_CHUNK
    assert tuple(fx["batch_shape"]) == smoke.TRAIN_BATCH
    assert tuple(fx["schedule"]) == smoke.TRAIN_SCHEDULE
    assert int(fx["steps"]) == smoke.TRAIN_STEPS == len(fx["losses"])
    cfg = smoke.zoo_config(fx)
    assert cfg.d_model == d_model and cfg.n_layers == n_layers
    assert cfg.dtype == "float32"
    assert int(fx["numel/tok_embed"]) == cfg.vocab_size * cfg.d_model
    assert abs(float(fx["loss"]) - float(fx["losses"][0])) < 1e-6
    assert np.isfinite(fx["losses"]).all() and fx["grad_norm"] > 0
    assert path.stat().st_size < 1 << 20
    return fx


def check_reduced_regeneration(arch: str, stacked_leaf: str):
    """A reduced regeneration of ``arch``'s fixture has the committed one's
    keys and dtypes, and ``chip_smoke.run_train_parity`` on the CPU
    reproduces it far inside the card's gates; a broken reading fails."""
    fx = build_train_fixture(arch, reduced=True)
    committed = smoke.load_fixture(smoke.RECURRENT_TRAIN[arch][0])
    assert fx.keys() == committed.keys()
    for k in fx:
        assert fx[k].dtype == committed[k].dtype, k
    got = smoke.run_train_parity(fx, "cpu")
    readings = smoke.check_train_parity(fx, got)
    assert readings["loss_max_abs_err"] < 1e-5
    assert readings["norm_max_rel_err"] < 1e-5
    assert readings["sample_gate"] < 0.01
    broken = dict(got, **{stacked_leaf: got[stacked_leaf] * 1.01})
    with pytest.raises(AssertionError, match="training parity missed"):
        smoke.check_train_parity(fx, broken)


# -- the scan's gradient -----------------------------------------------------


def _scan_inputs(B=2, T=13, H=3, N=8, seed=0, zero_decays=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, N)).astype(np.float32) * 0.5
               for _ in range(3))
    w = rng.uniform(0.3, 0.99, (B, T, H, N)).astype(np.float32)
    if zero_decays:  # the model's exp(-exp(dw)) rounds to 0 past dw ~ 4.5
        w = np.exp(-np.exp(rng.uniform(-6, 5, (B, T, H, N)))).astype(
            np.float32)
        assert (w == 0).any()
    u = rng.standard_normal((H, N)).astype(np.float32) * 0.3
    s0 = rng.standard_normal((B, H, N, N)).astype(np.float32)
    dy = rng.standard_normal((B, T, H, N)).astype(np.float32)
    ds = rng.standard_normal((B, H, N, N)).astype(np.float32)
    return r, k, v, w, u, s0, dy, ds


def _flat_oracle(r, k, v, w, u, s0):
    """The reference's oracle (flat (BH,T,N) layout) in the model layout."""
    B, T, H, N = r.shape

    def flat(x):
        return x.transpose(0, 2, 1, 3).reshape(B * H, T, N)

    y, s = kernel_ref_jax.rwkv6_scan_ref(
        flat(r), flat(k), flat(v), flat(w),
        jnp.broadcast_to(u[None], (B, H, N)).reshape(B * H, N),
        s0.reshape(B * H, N, N))
    return y.reshape(B, H, T, N).transpose(0, 2, 1, 3), s.reshape(B, H, N, N)


def _reference_vjp(fn, arrays, dy, ds):
    _, vjp = jax.vjp(fn, *map(jnp.asarray, arrays))
    return vjp((jnp.asarray(dy), jnp.asarray(
        np.zeros(arrays[-1].shape, np.float32) if ds is None else ds)))


@pytest.mark.parametrize("oracle", ["wkv_stepwise", "rwkv6_scan_ref"])
@pytest.mark.parametrize("state, dstate", [(True, True), (False, False),
                                           (True, False), (False, True)])
def test_wkv_bwd_ref_matches_reference_vjp(oracle, state, dstate):
    r, k, v, w, u, s0, dy, ds = _scan_inputs(seed=3)
    s0 = s0 if state else np.zeros_like(s0)
    ds = ds if dstate else None
    fn = rwkv_ref.wkv_stepwise if oracle == "wkv_stepwise" else _flat_oracle
    want = _reference_vjp(fn, (r, k, v, w, u, s0), dy, ds)
    got = ref.wkv_bwd_ref(*(torch.tensor(a) for a in (r, k, v, w, u)),
                          torch.tensor(s0) if state else None,
                          torch.tensor(dy),
                          None if ds is None else torch.tensor(ds))
    for name, g, wnt in zip(("dr", "dk", "dv", "dw", "du", "dstate0"), got,
                            want):
        close_leaf(g, wnt, SCAN_RTOL, name)


@pytest.mark.parametrize("zero_decays", [False, True])
def test_wkv_function_cpu_path_matches_reference_vjp(zero_decays):
    """``ops.wkv`` under grad (``WKV`` with the plain backward) against
    ``jax.vjp`` of ``wkv_stepwise``: y and the final state both used."""
    r, k, v, w, u, s0, dy, ds = _scan_inputs(T=37, N=16, seed=5,
                                             zero_decays=zero_decays)
    want = _reference_vjp(rwkv_ref.wkv_stepwise, (r, k, v, w, u, s0), dy, ds)
    leaves = [torch.tensor(a, requires_grad=True)
              for a in (r, k, v, w, u, s0)]
    y, s = ops.wkv(*leaves)
    assert y.grad_fn is not None and type(y.grad_fn).__name__ == "WKVBackward"
    got = torch.autograd.grad((y * torch.tensor(dy)).sum()
                              + (s * torch.tensor(ds)).sum(), leaves)
    for name, g, wnt in zip(("dr", "dk", "dv", "dw", "du", "dstate0"), got,
                            want):
        close_leaf(g, wnt, SCAN_RTOL, name)
    # the same y and state as without grad, and only y used: no state
    # cotangent reaches the backward
    with torch.no_grad():
        y0, s_0 = ops.wkv(*(t.detach() for t in leaves))
    assert torch.equal(y.detach(), y0) and torch.equal(s.detach(), s_0)
    want = _reference_vjp(rwkv_ref.wkv_stepwise, (r, k, v, w, u, s0), dy,
                          None)
    y, _ = ops.wkv(*leaves)
    got = torch.autograd.grad((y * torch.tensor(dy)).sum(), leaves)
    for name, g, wnt in zip(("dr", "dk", "dv", "dw", "du", "dstate0"), got,
                            want):
        close_leaf(g, wnt, SCAN_RTOL, name)


def test_wrappers_refuse_what_has_no_gradient():
    r, k, v, w, u, s0, dy, ds = (torch.tensor(a) for a in _scan_inputs())
    live = r.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="out= has no gradient"):
        ops.wkv(live, k, v, w, u, s0, out=torch.empty_like(s0))
    # without grad out= is taken and nothing is saved
    with torch.no_grad():
        out = torch.empty_like(s0)
        y, s = ops.wkv(live, k, v, w, u, s0, out=out)
    assert s is out and y.grad_fn is None
    y, s = ops.wkv(r, k, v, w, u, s0)  # nothing requires grad
    assert y.grad_fn is None and s.grad_fn is None
    # the backward kernel's wrapper: CPU tensors and other dtypes refused
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.rwkv6_scan_backward(r, k, v, w, u, s0, dy, ds)
    with pytest.raises(TypeError, match="float32"):
        kernel.rwkv6_scan_backward(r, k, v, w, u, s0, dy.double(), ds)
    with pytest.raises(ValueError, match="dy"):
        kernel.rwkv6_scan_backward(r, k, v, w, u, s0, dy[:, :1], ds)
    with pytest.raises(ValueError, match="dstate must be"):
        kernel.rwkv6_scan_backward(r, k, v, w, u, s0, dy, ds[..., :1])
    assert kernel.rwkv6_scan_backward.launches == 0
    # two kernels a call, in this order: the boundary pass, the chunks
    assert list(kernel.BWD_KERNELS) == ["bounds", "chunk"]
    assert kernel.rwkv6_scan_backward.launches_by_kernel == {"bounds": 0,
                                                             "chunk": 0}
    assert kernel.BWD_SOURCE.is_file()
    assert kernel.LIBRARIES["rwkv6_backward"] == [kernel.BWD_SOURCE]


# -- the model's loss and gradients -------------------------------------------


@pytest.mark.parametrize("scan_chunked", [False, True])
def test_loss_and_gradients_match_reference(scan_chunked):
    changes = {"scan_chunked": scan_chunked, "scan_chunk": 8}
    check_loss_and_gradients(get_config_ref(ARCH).reduced().replace(
        **changes), get_config(ARCH).reduced().replace(**changes))


def test_remat_block_equals_none_and_forward_matches_no_grad():
    cfg = get_config(ARCH).reduced()
    tree = smoke.numpy_params(cfg, 1)
    p = params_from_numpy(tree, "cpu")
    b = {k: torch.as_tensor(v) for k, v in smoke.train_batch(
        cfg, 1, (2, 20)).items()}
    loss, _, g = port_grads(get_model(cfg), p, b)
    loss_r, _, g_r = port_grads(get_model(cfg.replace(remat="block")), p, b)
    assert torch.equal(loss_r, loss)
    for a, c in zip(tree_leaves(g_r), tree_leaves(g)):
        assert torch.equal(a, c)
    # under grad the forward's hidden states and new cache are the
    # grad-free forward's, bit for bit
    live = tree_map(lambda t: t.detach().requires_grad_(True), p)
    h, _, cache = rwkv.forward(cfg, live, b)
    with torch.no_grad():
        h0, _, cache0 = rwkv.forward(cfg, p, b)
    assert torch.equal(h.detach(), h0)
    for name in cache0:
        assert torch.equal(cache[name].detach(), cache0[name]), name
    assert get_model(cfg).loss_fn(p, b)[0].requires_grad is False


# -- the phase-20 (b) fixture ----------------------------------------------


def test_committed_train_fixture_is_what_chip_smoke_reads():
    fx = check_committed_fixture(ARCH, 2560, 4)
    assert fx["norm/layers/w_r"].shape == (4,)


def test_reduced_train_fixture_regenerates_and_port_reproduces_it():
    check_reduced_regeneration(ARCH, "norm/layers/w_r")


if __name__ == "__main__":
    import resource
    import time

    t0 = time.perf_counter()
    arrays = build_train_fixture(ARCH, reduced=False)
    path = smoke.RECURRENT_TRAIN[ARCH][0]
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)
    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"wrote {path} ({path.stat().st_size} bytes) in "
          f"{time.perf_counter() - t0:.1f} s, peak resident {peak_gb:.1f} GB;"
          f" losses {arrays['losses']}, grad norm {arrays['grad_norm']}")
