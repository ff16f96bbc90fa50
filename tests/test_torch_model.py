"""The port's LSTM forecaster against the reference's, with the reference's
weights carried over (JAX -> numpy -> port)."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_ref
from repro.models import lstm as lstm_ref
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import lstm
from repro_torch.models.model import get_model


@pytest.fixture(scope="module")
def jax_params():
    cfg = get_config_ref("lstm-paper")
    return jax.tree_util.tree_map(
        np.asarray, lstm_ref.init_params(cfg, jax.random.PRNGKey(3)))


def test_config_matches_reference():
    ours, ref = get_config("lstm-paper"), get_config_ref("lstm-paper")
    assert ours.lstm.__dict__ == ref.lstm.__dict__
    for field in ("name", "family", "param_dtype", "citation"):
        assert getattr(ours, field) == getattr(ref, field)


def test_params_round_trip_exact(jax_params):
    port = params_from_numpy(jax_params, "cpu")
    assert set(port) == {"lstm", "dense", "head"}
    back = params_to_numpy(port)
    flat_ref = jax.tree_util.tree_leaves_with_path(jax_params)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_ref] == [p for p, _ in flat_back]
    for (_, a), (_, b) in zip(flat_ref, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_matches_reference_at_full_width(jax_params, use_pallas):
    """H=40, dense 10, F=5, lag 5, B=250: atol 1e-5."""
    cfg_ref = get_config_ref("lstm-paper")
    x = np.random.default_rng(0).random((250, 5, 5)).astype(np.float32)
    want = np.asarray(lstm_ref.forward(cfg_ref, jax_params, x,
                                       use_pallas=use_pallas))
    with torch.inference_mode():
        got = lstm.forward(get_config("lstm-paper"),
                           params_from_numpy(jax_params, "cpu"),
                           torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (250, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_init_layout_and_forward(jax_params):
    model = get_model(get_config("lstm-paper"))
    p = model.init(torch.Generator().manual_seed(0), "cpu")
    for sub, leaves in jax_params.items():
        for k, v in leaves.items():
            assert tuple(p[sub][k].shape) == v.shape
            assert p[sub][k].dtype == torch.float32
    bias = p["lstm"]["bias"]
    assert torch.equal(bias[40:80], torch.ones(40))
    assert not bias[:40].any() and not bias[80:].any()
    assert p["lstm"]["kernel"].abs().max() <= 2 * 5**-0.5
    again = model.init(torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(p["lstm"]["recurrent"], again["lstm"]["recurrent"])
    with torch.inference_mode():
        y = model.predict(p, torch.zeros(3, 5, 5))
    assert y.shape == (3, 1) and torch.isfinite(y).all()


def test_forward_rejects_non_tensor_leaves(jax_params):
    """A leaf that is neither a tensor nor a QTensor cannot multiply."""
    p = params_from_numpy(jax_params, "cpu")
    p["dense"]["dense_w"] = object()
    with pytest.raises(TypeError, match="unsupported operand"):
        lstm.forward(get_config("lstm-paper"), p, torch.zeros(2, 5, 5))
