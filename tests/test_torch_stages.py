"""The port's single-stream stages and executor bookkeeping against the
reference's stage objects on the same inputs."""
import numpy as np
import pytest
import torch

from repro.core import stages as stages_ref
from repro_torch.core import stages
from repro_torch.runtime.executor import window_seeds


def _prev(seed=0, n=200):
    rng = np.random.default_rng(seed)
    y = rng.random((n, 1)).astype(np.float32)
    return ((y + rng.normal(scale=0.1, size=y.shape)).astype(np.float32),
            (y + 0.05 + rng.normal(scale=0.05, size=y.shape)).astype(
                np.float32)), y


@pytest.mark.parametrize("mode,solver", [
    ("dynamic", "closed_form"), ("dynamic", "scipy"), (("static", 0.3), None),
    ("speed", None), ("batch", None)])
@pytest.mark.parametrize("first_window", [True, False])
def test_weight_solve_matches_reference(mode, solver, first_window):
    preds, y = _prev()
    kw = ({"prev_preds": None, "prev_y": None} if first_window
          else {"prev_preds": preds, "prev_y": y})
    ours = stages.WeightSolve(mode, solver or "closed_form")(**kw)
    ref = stages_ref.WeightSolve(mode, solver or "closed_form")(**kw)
    assert ours.wall_s >= 0
    np.testing.assert_allclose([ours["w_speed"], ours["w_batch"]],
                               [ref["w_speed"], ref["w_batch"]], rtol=0,
                               atol=1e-12)


def test_weight_solve_rejects_unknown_mode():
    with pytest.raises(ValueError, match="unknown mode"):
        stages.WeightSolve("median")(prev_preds=None, prev_y=None)


def test_combine_and_speed_fallback():
    (ps, pb), _ = _prev(1)
    out = stages.HybridCombine()(pred_speed=ps, pred_batch=pb, w_speed=0.25,
                                 w_batch=0.75)
    np.testing.assert_array_equal(out["pred"], stages_ref.HybridCombine()(
        pred_speed=ps, pred_batch=pb, w_speed=0.25, w_batch=0.75)["pred"])

    class Fc:
        def predict(self, params, x):
            return np.full((len(x), 1), params)

    s = stages.SpeedInference(Fc())
    got = s(speed_params=None, x=np.zeros((3, 5, 5)), fallback_params=2.0)
    assert got["fallback"] and (got["pred"] == 2.0).all()
    with pytest.raises(ValueError, match="no speed model"):
        s(speed_params=None, x=np.zeros((3, 5, 5)))


def test_model_sync_passes_through_and_refuses_integrity_checks():
    """A publish passes through; its checksum is verified as the
    reference's stage verifies it (a mismatch rejects, counted); with a
    ``sig_key`` its signature too, as the reference's stage checks it: a
    good one installs, a bad or missing one rejects marked ``forged`` and
    counts in ``forged_rejected``."""
    from repro.runtime.health import sign_tree as jax_sign_tree
    from repro_torch.runtime.health import derive_sync_key, sign_tree
    from repro.runtime.faults import tree_checksum as jax_tree_checksum
    from repro_torch.serving.quantize import tree_checksum

    ms, ms_ref = stages.ModelSync(), stages_ref.ModelSync()
    p = {"lstm": {"kernel": torch.zeros(2)}}
    p_ref = {"lstm": {"kernel": np.zeros(2, np.float32)}}
    out = ms(params=p, eval_preds=None, eval_y=None)
    assert out["ok"] and out["speed_params"] is p
    good = tree_checksum(p)
    assert good == jax_tree_checksum(p_ref)
    for checksum in (good, good ^ 1):
        got = ms(params=p, eval_preds=None, eval_y=None, checksum=checksum)
        want = ms_ref(params=p_ref, eval_preds=None, eval_y=None,
                      checksum=checksum)
        assert got["ok"] == want["ok"] == (checksum == good)
        assert (got["speed_params"] is None) == (want["speed_params"] is None)
    assert (ms.verified, ms.corrupt_rejected) == (1, 1)
    assert (ms_ref.verified, ms_ref.corrupt_rejected) == (1, 1)
    key = derive_sync_key(0)
    sig = sign_tree(p, key)
    assert sig == jax_sign_tree(p_ref, key)
    for signature in (sig, sig[::-1], None):
        got = ms(params=p, eval_preds=None, eval_y=None, checksum=good,
                 signature=signature, sig_key=key)
        want = ms_ref(params=p_ref, eval_preds=None, eval_y=None,
                      checksum=good, signature=signature, sig_key=key)
        assert got["ok"] == want["ok"] == (signature == sig)
        assert got.values.get("forged") == want.values.get("forged")
        assert (got["speed_params"] is p) == got["ok"]
    # a signature without a key is not checked, as in the reference
    assert ms(params=p, eval_preds=None, eval_y=None, signature="s")["ok"]
    assert (ms.verified, ms.corrupt_rejected, ms.forged_rejected) == \
        (ms_ref.verified, ms_ref.corrupt_rejected,
         ms_ref.forged_rejected) == (4, 1, 2)
    assert stages.DataSync()(nbytes=12.0)["nbytes"] == 12.0


def test_pipeline_stages_build_and_window_seeds():
    st = stages.PipelineStages.build(object(), ("static", 0.3), "scipy")
    assert st.mode == ("static", 0.3)
    assert st.weight_solve.dwa_solver == "scipy"
    assert not st.weight_solve.is_dynamic
    seeds = window_seeds(1, 6)
    assert seeds == window_seeds(1, 6) != window_seeds(2, 6)
    assert len(set(seeds)) == 6 and all(isinstance(k, int) for k in seeds)
    assert window_seeds(1, 0) == []
