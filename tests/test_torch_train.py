"""The port's training modules against the reference's on the same numpy
inputs: AdamW, the masked loss, shape buckets, one train step at full width,
and the compiled forecaster's own guarantees (mask check, reproducible
fits, warm starts that leave the served model alone)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_ref
from repro.models import lstm as lstm_ref
from repro.models.model import get_model as get_model_ref
from repro.training import compiled as compiled_ref
from repro.training import optimizer as optimizer_ref
from repro.training.train_loop import make_train_step as make_train_step_ref
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import lstm_forecaster
from repro_torch.models import lstm
from repro_torch.models.model import get_model
from repro_torch.training import compiled, optimizer
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.train_loop import make_train_step


def _window(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 5, 5)).astype(np.float32)
    y = x[:, :, 0].mean(axis=1, keepdims=True).astype(np.float32)
    return {"x": x, "y": y}


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(
        np.asarray,
        lstm_ref.init_params(get_config_ref("lstm-paper"),
                             jax.random.PRNGKey(5)))


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("grad_scale", [0.005, 3.0])  # global norm < 1, > 1
def test_adamw_matches_reference(jax_params, grad_scale, weight_decay):
    """Five updates on the same gradients, with clipping inactive (global
    norm < 1) and active: params and moments to 1e-7."""
    rng = np.random.default_rng(1)
    grads = [jax.tree_util.tree_map(
        lambda p: (rng.normal(size=p.shape) * grad_scale).astype(np.float32),
        jax_params) for _ in range(5)]
    norms = [float(optimizer_ref.global_norm(g)) for g in grads]
    assert all((n > 1) == (grad_scale > 1) for n in norms)

    opt_ref = optimizer_ref.adamw(1e-3, weight_decay=weight_decay)
    p_ref, s_ref = jax_params, opt_ref.init(jax_params)
    opt = optimizer.adamw(1e-3, weight_decay=weight_decay)
    p = params_from_numpy(jax_params, "cpu")
    s = opt.init(p)
    for g in grads:
        p_ref, s_ref, m_ref = opt_ref.update(g, s_ref, p_ref)
        p, s, m = opt.update(params_from_numpy(g, "cpu"), s, p)
        assert float(m["grad_norm"]) == pytest.approx(float(m_ref["grad_norm"]),
                                                      rel=1e-6)
    assert int(s.step) == int(s_ref.step) == 5
    for got, want in ((p, p_ref), (s.mu, s_ref.mu), (s.nu, s_ref.nu)):
        for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-7)


def test_loss_fn_with_mask_matches_reference_and_unpadded_mean(jax_params):
    cfg, cfg_ref = get_config("lstm-paper"), get_config_ref("lstm-paper")
    data = _window(150, seed=2)
    padded = compiled.pad_to_bucket(data, 256)
    p = params_from_numpy(jax_params, "cpu")
    with torch.no_grad():
        plain, plain_m = lstm.loss_fn(
            cfg, p, {k: torch.from_numpy(v) for k, v in data.items()})
        masked, masked_m = lstm.loss_fn(
            cfg, p, {k: torch.from_numpy(v) for k, v in padded.items()})
    want, want_m = lstm_ref.loss_fn(
        cfg_ref, jax_params, {k: jnp.asarray(v) for k, v in padded.items()})
    assert float(masked) == pytest.approx(float(want), rel=1e-6)
    assert float(masked_m["rmse"]) == pytest.approx(float(want_m["rmse"]),
                                                    rel=1e-6)
    assert float(masked) == pytest.approx(float(plain), rel=1e-6)
    assert float(masked_m["mse"]) == float(masked)
    assert float(plain_m["rmse"]) == pytest.approx(np.sqrt(float(plain)))


@pytest.mark.parametrize("n", [1, 64, 245, 250, 1595])
def test_buckets_and_padding_match_reference(n):
    for batch_size in (64, 256):
        nb = compiled.bucket_examples(n, batch_size)
        assert nb == compiled_ref.bucket_examples(n, batch_size)
        data = _window(n, seed=n)
        ours = compiled.pad_to_bucket(data, nb)
        ref = compiled_ref.pad_to_bucket(data, nb)
        assert sorted(ours) == sorted(ref)
        for k in ref:
            assert ours[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(ours[k], ref[k])


def test_bucket_rejects_empty_and_oversized_windows():
    with pytest.raises(ValueError, match="empty"):
        compiled.bucket_examples(0, 64)
    with pytest.raises(ValueError, match="exceeds"):
        compiled.pad_to_bucket(_window(65), 64)


def test_train_step_matches_reference_at_full_width(jax_params):
    """One step of each ``make_train_step`` at LSTM(40), batch 64 with a
    padded mask: params, moments and loss to 1e-6."""
    cfg, cfg_ref = get_config("lstm-paper"), get_config_ref("lstm-paper")
    batch = compiled.pad_to_bucket(_window(50, seed=3), 64)
    opt_ref = optimizer_ref.adamw(1e-3)
    step_ref = make_train_step_ref(get_model_ref(cfg_ref), opt_ref)
    p_ref, s_ref, m_ref = step_ref(jax_params, opt_ref.init(jax_params),
                                   {k: jnp.asarray(v) for k, v in batch.items()})
    opt = optimizer.adamw(1e-3)
    p = params_from_numpy(jax_params, "cpu")
    step = make_train_step(get_model(cfg), opt)
    p, s, m = step(p, opt.init(p),
                   {k: torch.from_numpy(v) for k, v in batch.items()})
    assert not any(t.requires_grad for t in tree_leaves(p))
    assert float(m["loss"]) == pytest.approx(float(m_ref["loss"]), rel=1e-6)
    for got, want in ((p, p_ref), (s.mu, s_ref.mu), (s.nu, s_ref.nu)):
        for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)


def test_mask_blind_model_rejected():
    cfg = get_config("lstm-paper")
    model = get_model(cfg)
    blind = dataclasses.replace(model, loss_fn=lambda p, b: lstm.loss_fn(
        cfg, p, {"x": b["x"], "y": b["y"]}))  # drops the mask
    eng = compiled.CompiledForecaster(blind, epochs=1, batch_size=64,
                                      device="cpu")
    with pytest.raises(ValueError, match="mask"):
        eng.train(_window(150), None, 0)
    # no padding needed: the mask is irrelevant and the model trains
    params, wall = eng.train(_window(64), None, 0)
    assert wall > 0 and eng.fits == 1 and eng.steps == 1
    assert all(torch.isfinite(t).all() for t in tree_leaves(params))


def test_compiled_train_reproducible_and_draws_permutations():
    """The same integer key gives bit-identical params; each epoch's rows
    of the drawn indices are a permutation of the padded bucket."""
    fc = lstm_forecaster(get_config("lstm-paper"), epochs=3, batch_size=64,
                         device="cpu")
    eng, data = fc.engine, _window(245, seed=4)
    a, _ = fc.train(data, None, 11)
    b, _ = fc.train(data, None, 11)
    c, _ = fc.train(data, None, 12)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                  tree_leaves(b)))
    assert not torch.equal(tree_leaves(a)[0], tree_leaves(c)[0])
    assert eng.fits == 3 and eng.steps == 3 * 3 * 4
    assert eng.last_losses.shape == (12,) and np.isfinite(eng.last_losses).all()
    idx = eng.permutations(256, torch.Generator().manual_seed(11))
    assert tuple(idx.shape) == (12, 64)
    for epoch in idx.reshape(3, 256):
        assert torch.equal(epoch.sort().values, torch.arange(256))
    with pytest.raises(ValueError, match="needs"):
        eng.fit_window(data, eng.model.init(torch.Generator(), "cpu"),
                       idx[:-1])


def test_warm_start_trains_a_copy_and_leaves_the_callers_params():
    fc = lstm_forecaster(get_config("lstm-paper"), epochs=2, batch_size=64,
                         warm_start=True, device="cpu")
    served, _ = fc.train(_window(120, seed=5), None, 1)  # cold: no params
    before = params_to_numpy(served)
    trained, _ = fc.train(_window(120, seed=6), served, 2)
    for k, sub in before.items():
        for leaf, v in sub.items():
            np.testing.assert_array_equal(served[k][leaf].numpy(), v)
    assert not torch.equal(trained["lstm"]["kernel"], served["lstm"]["kernel"])


def test_forecaster_trains_through_its_engine_and_learns():
    """``lstm_forecaster``'s ``train`` is its ``CompiledForecaster``'s: one
    fit a call, every step of the bucket taken, and the masked loss falls
    from the first epoch to the last on a learnable window."""
    fc = lstm_forecaster(get_config("lstm-paper"), epochs=20, batch_size=64,
                         device="cpu")
    assert isinstance(fc.engine, compiled.CompiledForecaster)
    assert fc.train == fc.engine.train and fc.predict == fc.engine.predict
    params, wall = fc.train(_window(150, seed=7), None, 3)
    assert wall > 0 and fc.engine.fits == 1 and fc.engine.steps == 20 * 4
    epochs = fc.engine.last_losses.reshape(20, 4).mean(axis=1)
    assert epochs[-1] < 0.5 * epochs[0]
    y = fc.predict(params, _window(150, seed=7)["x"])
    assert y.shape == (150, 1) and np.isfinite(y).all()
