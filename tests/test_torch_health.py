"""The port's health plane (``runtime/health.py``) held to the reference's:
the counterparts of ``tests/test_health.py``, each fed what the
reference's test feeds its own and compared with the reference's answer;
``sign_tree`` equal to the reference's hex digest on the same float and
int8 trees; and ``PhiAccrual``, ``SiteMonitor``, ``ByzantineGuard``,
``FaultRateEstimator``, the adaptive thresholds and ``reset`` driven by
one seeded event sequence on both sides, every verdict, adaptation,
pressure and summary equal."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import faults as ref_faults
from repro.runtime import health as ref_health
from repro.serving import quantize as ref_quantize
from repro_torch.core import stages
from repro_torch.runtime import faults, health
from repro_torch.serving import quantize
from repro_torch.stacked import FleetParamView, _FleetStack

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

BOTH = (health, ref_health)


def _tree():
    return {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
            "q": np.arange(6, dtype=np.int8)}


def _torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _bound(mod, cfg=None, **kw):
    hp = mod.HealthPlane(cfg if cfg is not None else mod.HealthConfig())
    args = dict(sites=["edge", "cloud"], hb_interval_s=1.0, halflife_s=2.0,
                quarantine_after=3, staleness_bound=1, sync_seed=0)
    args.update(kw)
    hp.bind(**args)
    return hp


# ---------------------------------------------------------------------------
# signed sync
# ---------------------------------------------------------------------------


def test_sign_tree_equals_reference_digest():
    """The same float tree, the lstm-paper model and its int8 tree (a
    ``QTensor`` as ``q`` then ``scale``), and a fleet view of it, under two
    keys: the port's hex digest is the reference's."""
    m = smoke.unflatten(smoke.load_fixture(smoke.FLEET_FIXTURE), "batch")
    ours, ref = _torch(m), jax.tree_util.tree_map(jnp.asarray, m)
    trees = [(_torch(_tree()), _tree()), (ours, ref),
             (quantize.quantize_tree(ours, min_size=64),
              ref_quantize.quantize_tree(ref, min_size=64))]
    stacked = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.stack([np.array(a), np.array(a) + 1])),
        m)
    trees.append((FleetParamView(_FleetStack(stacked), 0), ref))
    for seed in (0, 7):
        for mod in BOTH:
            assert mod.derive_sync_key(seed) == \
                ref_health.derive_sync_key(seed)
        key = health.derive_sync_key(seed)
        for a, b in trees:
            sig = health.sign_tree(a, key)
            assert sig == ref_health.sign_tree(b, key)
            assert health.verify_tree(a, key, sig)
            assert ref_health.verify_tree(b, key, sig)


def test_sign_verify_roundtrip_and_key_separation():
    key = health.derive_sync_key(0)
    tree = _torch(_tree())
    sig = health.sign_tree(tree, key)
    assert health.verify_tree(tree, key, sig)
    assert not health.verify_tree(tree, key, None)
    assert not health.verify_tree(tree, health.derive_sync_key(1), sig)
    assert health.derive_sync_key(3) == health.derive_sync_key(3)


def test_forged_tree_passes_recomputed_checksum_but_fails_hmac():
    """A forger perturbs the params and recomputes the CRC32: a
    checksum-only receiver would install it, the HMAC does not."""
    key = health.derive_sync_key(0)
    tree = _torch(_tree())
    sig = health.sign_tree(tree, key)
    forged = faults.forge_tree(tree, np.random.default_rng(0))
    want = ref_faults.forge_tree(_tree(), np.random.default_rng(0))
    assert faults.tree_checksum(forged) == ref_faults.tree_checksum(want)
    assert faults.tree_checksum(forged) != faults.tree_checksum(tree)
    assert not health.verify_tree(forged, key, sig)
    assert not health.verify_tree(forged, key,
                                  health.sign_tree(forged, b"wrong-key" * 4))


def test_model_sync_signature_matches_reference():
    """``ModelSync`` with a ``sig_key``: the checksum first, then the
    signature; a good signature installs, a bad or missing one rejects
    marked ``forged`` and counts in ``forged_rejected``; a bad checksum is
    counted corrupt before the signature is read; each as the reference's
    stage answers on the same publish."""
    from repro.core import stages as ref_stages

    key = health.derive_sync_key(0)
    ours, ref = stages.ModelSync(), ref_stages.ModelSync()
    p, p_ref = _torch(_tree()), _tree()
    ck, sig = faults.tree_checksum(p), health.sign_tree(p, key)
    cases = [(ck, sig), (ck, "0" * 64), (ck, None), (ck ^ 1, sig),
             (None, sig), (None, None)]
    for checksum, signature in cases:
        got = ours(params=p, eval_preds=None, eval_y=None, checksum=checksum,
                   signature=signature, sig_key=key)
        want = ref(params=p_ref, eval_preds=None, eval_y=None,
                   checksum=checksum, signature=signature, sig_key=key)
        assert got.values.keys() == want.values.keys()
        assert got["ok"] == want["ok"]
        assert got.values.get("forged") == want.values.get("forged")
        assert (got["speed_params"] is p) == got["ok"]
    assert (ours.verified, ours.corrupt_rejected, ours.forged_rejected) == \
        (ref.verified, ref.corrupt_rejected, ref.forged_rejected) == (3, 1, 3)


# ---------------------------------------------------------------------------
# detection: phi accrual and the site monitors
# ---------------------------------------------------------------------------


def test_phi_accrual_rises_only_when_heartbeats_stop():
    for mod in BOTH:
        tr = mod.PhiAccrual(expected_s=1.0, window=16)
        for k in range(1, 9):
            tr.arrive(float(k), healthy=True)
        assert tr.phi(8.4) == pytest.approx(0.4, abs=0.05)
        assert tr.phi(9.8) == pytest.approx(1.8, abs=0.05)
        tr.arrive(10.0, healthy=True)
        assert tr.phi(10.1) < 0.2


def test_phi_accrual_excludes_outage_gap_from_baseline():
    for mod in BOTH:
        tr = mod.PhiAccrual(expected_s=1.0, window=16)
        for k in range(1, 6):
            tr.arrive(float(k), healthy=True)
        tr.arrive(15.0, healthy=False)
        assert tr.mean() == pytest.approx(1.0, abs=1e-6)
        tr.arrive(15.1, healthy=True)
        assert tr.mean() == pytest.approx(1.0, abs=1e-6)


def test_site_monitor_escalates_and_recovers():
    planes = []
    for mod in BOTH:
        hp = _bound(mod, quarantine_after=3)
        for k in range(1, 7):
            hp.observe_heartbeat("edge", "cloud", float(k))
            hp.check("edge", k + 0.5)
        assert hp.verdict_stats.get("partition_suspected", 0) == 0
        for t in (7.5, 8.5, 9.5):
            hp.check("edge", t)
        assert hp.verdict_stats["partition_suspected"] == 1
        assert hp.verdict_stats["site_down"] == 1
        assert hp.first_verdict_t("partition_suspected") == 7.5
        hp.observe_heartbeat("edge", "cloud", 10.0)
        assert hp.verdict_stats["recovered"] == 1
        planes.append(hp)
    assert planes[0].verdicts == planes[1].verdicts
    assert planes[0].summary() == planes[1].summary()


def test_site_monitor_rebaselines_after_its_own_outage():
    planes = []
    for mod in BOTH:
        hp = _bound(mod)
        for k in range(1, 4):
            hp.observe_heartbeat("edge", "cloud", float(k))
            hp.check("edge", k + 0.5)
        hp.check("edge", 8.5)
        assert hp.verdict_stats.get("monitor_gap", 0) == 1
        assert hp.verdict_stats.get("partition_suspected", 0) == 0
        hp.observe_heartbeat("edge", "cloud", 9.0)
        hp.check("edge", 9.5)
        assert hp.verdict_stats.get("partition_suspected", 0) == 0
        planes.append(hp)
    assert planes[0].verdicts == planes[1].verdicts


# ---------------------------------------------------------------------------
# the Byzantine guard
# ---------------------------------------------------------------------------


def _warm_guard(mod, cfg):
    g = mod.ByzantineGuard(cfg)
    base = np.random.default_rng(0).normal(10.0, 1.0, 200).astype(np.float32)
    g.screen("t00", {"x": np.zeros((200, 5), np.float32), "y": base}, 0.0)
    return g


def test_byzantine_guard_flags_and_imputes_outliers():
    outs = []
    for mod in BOTH:
        g = _warm_guard(mod, mod.HealthConfig())
        y = np.array([10.0, 10.5, 60.0, 9.5], np.float32)
        out, n = g.screen("t00", {"x": np.zeros((4, 5), np.float32),
                                  "y": y}, 1.0)
        assert n == 1 and out["y"][2] != 60.0
        assert abs(out["y"][2] - 10.0) < 1.0
        assert list(out["y"][[0, 1, 3]]) == [10.0, 10.5, 9.5]
        assert g.flagged["t00"] == 1
        outs.append(out["y"])
    np.testing.assert_array_equal(*outs)


def test_byzantine_guard_returns_original_objects_when_clean():
    g = _warm_guard(health, health.HealthConfig())
    data = {"x": np.zeros((4, 5), np.float32),
            "y": np.array([10.0, 9.8, 10.2, 10.1], np.float32)}
    out, n = g.screen("t00", data, 1.0)
    assert n == 0 and out is data


def test_byzantine_guard_inactive_until_min_history():
    g = health.ByzantineGuard(health.HealthConfig(byz_min_history=48))
    y = np.array([1e6], np.float32)
    out, n = g.screen("t00", {"x": np.zeros((1, 5), np.float32), "y": y},
                      0.0)
    assert n == 0 and out["y"][0] == 1e6


def test_byzantine_guard_equals_reference_on_a_stream():
    """Forty windows of a drifting target with a quarter of some windows
    offset by 8 to 10 robust sigmas (``SensorFault``'s Byzantine values):
    the port's screened windows, flags and counts equal the reference's."""
    rng = np.random.default_rng(4)
    windows = []
    for w in range(40):
        y = (np.sin(np.arange(60) / 9.0 + w) + rng.normal(0, 0.1, 60)
             ).astype(np.float32)[:, None]
        if w % 3 == 2:
            rows = rng.choice(60, 15, replace=False)
            y[rows] += np.float32(8.0 * rng.choice([-1, 1]))
        windows.append({"x": np.zeros((60, 5), np.float32), "y": y})
    got = {}
    for mod in BOTH:
        g = mod.ByzantineGuard(mod.HealthConfig(byz_min_history=48))
        got[mod] = [g.screen(sid, d, float(w)) for w, d in enumerate(windows)
                    for sid in ("t00", "t01")]
        got[mod].append((dict(g.flagged), g.screened))
    ours, ref = got[health], got[ref_health]
    for (a, na), (b, nb) in zip(ours[:-1], ref[:-1]):
        assert na == nb
        np.testing.assert_array_equal(a["y"], b["y"])
    assert ours[-1] == ref[-1] and sum(ours[-1][0].values()) > 0


# ---------------------------------------------------------------------------
# fault rates and adaptive thresholds
# ---------------------------------------------------------------------------


def test_fault_rate_estimator_decays_by_halflife():
    for mod in BOTH:
        est = mod.FaultRateEstimator(halflife_s=10.0)
        est.observe(0.0)
        est.observe(0.0)
        assert est.pressure(0.0) == pytest.approx(2.0)
        assert est.pressure(10.0) == pytest.approx(1.0)
        assert est.pressure(20.0) == pytest.approx(0.5)


def test_adaptive_thresholds_tighten_under_rising_fault_rate():
    summaries = []
    for mod in BOTH:
        hp = _bound(mod, halflife_s=10.0, staleness_bound=2)
        assert hp.quarantine_after("t00", 0.0) == 3
        assert hp.staleness_bound("t00", 0.0) == 2
        assert hp.adaptations == []
        hp.observe_fault("sensor", "t00", 1.0)
        assert hp.quarantine_after("t00", 1.0) == 3
        for t in (2.0, 2.5, 3.0, 3.5):
            hp.observe_fault("sensor", "t00", t)
        tightened = hp.quarantine_after("t00", 4.0)
        assert 1 <= tightened < 3
        assert hp.summary()["adapted_quarantine_after"]["t00"] == tightened
        assert hp.quarantine_after("t01", 4.0) == 3
        for t in (2.0, 2.5, 3.0, 3.5):
            hp.observe_fault("link", "cloud", t)
        assert hp.staleness_bound("t00", 4.0) < 2
        assert hp.quarantine_after("t00", 500.0) == 3
        assert hp.staleness_bound("t00", 500.0) == 2
        summaries.append((hp.adaptations, hp.summary()))
    assert summaries[0] == summaries[1]


def test_static_plane_never_adapts():
    for mod in BOTH:
        hp = _bound(mod, mod.HealthConfig(adaptive=False), halflife_s=10.0,
                    staleness_bound=2)
        for t in (1.0, 1.2, 1.4, 1.6, 1.8):
            hp.observe_fault("sensor", "t00", t)
        assert hp.quarantine_after("t00", 2.0) == 3
        assert hp.staleness_bound("t00", 2.0) == 2
        assert hp.adaptations == []


def test_health_plane_reset_rewinds_everything():
    for mod in BOTH:
        hp = _bound(mod, halflife_s=10.0)
        hp.observe_fault("sensor", "t00", 1.0)
        hp.verdict(1.0, "partition_suspected", "edge", "cloud")
        hp.reset()
        assert hp.verdicts == [] and hp.pressure("sensor", "t00", 1.0) == 0.0
        assert hp.sync_key is None


@pytest.mark.parametrize("seed", range(4))
def test_event_sequence_equals_reference(seed):
    """One seeded sequence of heartbeats (with gaps, bursts and a silent
    peer), checks (with a dark monitor), sensor and sync faults and
    threshold reads over three sites, fed to both planes: every verdict,
    adaptation, pressure, threshold and the summary equal; after ``reset``
    and a second ``bind`` the replay is identical."""
    rng = np.random.default_rng(seed)
    sites = ["edge", "cloud", "fog"]
    events = []
    t = 0.0
    for _ in range(400):
        t += float(rng.exponential(0.3))
        r = rng.random()
        if r < 0.45:
            obs, peer = rng.choice(sites, 2, replace=False)
            if not (peer == "fog" and 20.0 < t < 35.0):
                events.append(("hb", str(obs), str(peer), t))
        elif r < 0.7:
            obs = str(rng.choice(sites))
            if not (obs == "edge" and 50.0 < t < 58.0):
                events.append(("check", obs, "", t))
        elif r < 0.8:
            events.append(("fault", str(rng.choice(["sensor", "sync"])),
                           f"t0{rng.integers(3)}", t))
        else:
            events.append(("read", f"t0{rng.integers(3)}", "", t))
    logs = {}
    for mod in BOTH:
        hp = mod.HealthPlane(mod.HealthConfig())
        log = logs[mod] = []
        for rep in range(2):
            hp.reset()
            hp.bind(sites=sites, hb_interval_s=1.0, halflife_s=4.0,
                    quarantine_after=4, staleness_bound=2, sync_seed=seed)
            for kind, a, b, when in events:
                if kind == "hb":
                    hp.observe_heartbeat(a, b, when)
                elif kind == "check":
                    hp.check(a, when)
                elif kind == "fault":
                    hp.observe_fault(a, b, when)
                else:
                    log.append((hp.quarantine_after(a, when),
                                hp.staleness_bound(a, when),
                                hp.pressure("sensor", a, when),
                                hp.pressure("sync", a, when)))
            log.append((list(hp.verdicts), list(hp.adaptations),
                        hp.summary(), hp.sync_key))
    assert logs[health] == logs[ref_health]
    final = logs[health][-1]
    assert final == logs[health][len(logs[health]) // 2 - 1]
    kinds = {v[1] for v in final[0]}
    assert {"partition_suspected", "recovered"} <= kinds
    assert final[1]  # some threshold tightened
