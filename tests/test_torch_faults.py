"""The port's fault plane (``runtime/faults.py``) held to the reference's:
the same seed and inputs give the same fault schedule (message, partition,
site and sensor faults, every event and every delivery time), and another
seed another; ``corrupt_tree`` and ``forge_tree`` flip the same bit of, or
add the same noise to, the same leaf of a float or int8 ``QTensor`` tree,
a ``FleetParamView`` read as its tree; a forged payload's checksum is
recomputed over the forged tree, as the reference's is."""
import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import EventKernel as RefEventKernel
from repro.runtime import faults as ref_faults
from repro.serving import quantize as ref_quantize
from repro_torch.runtime import EventKernel, faults
from repro_torch.serving import quantize
from repro_torch.serving.quantize import QTensor, tree_checksum, tree_leaves
from repro_torch.stacked import FleetParamView, _FleetStack

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


def _model():
    """The fleet fixture's batch model (lstm-paper, 7,781 parameters) as
    numpy."""
    return smoke.unflatten(smoke.load_fixture(smoke.FLEET_FIXTURE), "batch")


def _port(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _trees(quantized):
    """The same model as the port's tree (tensors) and the reference's
    (jax arrays), int8-quantized on both sides when ``quantized``."""
    m = _model()
    ours, ref = _port(m), _jax(m)
    if quantized:
        ours = quantize.quantize_tree(ours, min_size=64)
        ref = ref_quantize.quantize_tree(ref, min_size=64)
    return ours, ref


def _host_leaves(tree):
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in tree_leaves(tree)]


def _ref_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _assert_leaves_equal(ours, ref):
    a, b = _host_leaves(ours), _ref_leaves(ref)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))


# ---------------------------------------------------------------------------
# corrupt_tree and forge_tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("op", ["corrupt_tree", "forge_tree"])
def test_tree_faults_equal_reference(quantized, op):
    """Seeds 0-7 on the float and the int8 tree: the port's copy equals the
    reference's leaf for leaf and bit for bit, the original is untouched,
    each leaf comes back as the input's (a tensor on its device), and the
    structure (``QTensor`` leaves, key order) is kept."""
    ours, ref = _trees(quantized)
    before = tree_checksum(ours)
    changed = set()
    for seed in range(8):
        got = getattr(faults, op)(ours, np.random.default_rng(seed))
        want = getattr(ref_faults, op)(ref, np.random.default_rng(seed))
        _assert_leaves_equal(got, want)
        assert tree_checksum(got) == ref_faults.tree_checksum(want) != before
        assert list(got) == list(ours)
        for k in got:
            for j, v in got[k].items():
                assert type(v) is type(ours[k][j])
                if isinstance(v, QTensor):
                    assert isinstance(v.q, torch.Tensor)
                    assert v.orig_dtype == ours[k][j].orig_dtype
        changed |= {i for i, (x, y) in enumerate(zip(
            _host_leaves(got), _host_leaves(ours))) if not np.array_equal(
                x.view(np.uint8), y.view(np.uint8))}
    assert tree_checksum(ours) == before
    assert len(changed) > 1  # the RNG picks among the leaves


@pytest.mark.parametrize("op", ["corrupt_tree", "forge_tree"])
def test_tree_faults_on_numpy_and_a_fleet_view(op):
    """Numpy in, numpy out, equal to the reference's on the same arrays; a
    ``FleetParamView`` is read as its stream's tree."""
    m = _model()
    got = getattr(faults, op)(m, np.random.default_rng(3))
    want = getattr(ref_faults, op)(m, np.random.default_rng(3))
    assert all(isinstance(x, np.ndarray) for x in tree_leaves(got))
    _assert_leaves_equal(got, want)
    stacked = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.stack([np.array(a) * 0.5,
                                             np.array(a)])), m)
    view = FleetParamView(_FleetStack(stacked), 1)
    got = getattr(faults, op)(view, np.random.default_rng(3))
    _assert_leaves_equal(got, want)
    assert all(isinstance(x, torch.Tensor) for x in tree_leaves(got))


def test_tree_checksum_catches_single_bit_flip():
    """As ``tests/test_chaos.py``: every one-bit corruption changes the
    checksum, and ``corrupt_tree`` copies, never mutates."""
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": torch.zeros(4, dtype=torch.int8)}
    ck = tree_checksum(tree)
    assert ck == tree_checksum(tree) == ref_faults.tree_checksum(
        {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
         "b": np.zeros(4, np.int8)})
    for trial in range(8):
        bad = faults.corrupt_tree(tree, np.random.default_rng(trial))
        assert tree_checksum(bad) != ck
    assert tree_checksum(tree) == ck


def test_tree_checksum_sees_shape_and_dtype():
    """As ``tests/test_health.py``: the same bytes under another shape or
    type give another checksum, each equal to the reference's."""
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    raw = np.arange(8, dtype=np.int8)
    for tree in ({"w": a}, {"w": a.reshape(4, 3)}, {"q": raw},
                 {"q": raw.view(np.uint8)}):
        assert faults.tree_checksum(_port(tree)) == \
            ref_faults.tree_checksum(tree)
    assert faults.tree_checksum({"w": a}) != \
        faults.tree_checksum({"w": a.reshape(4, 3)})
    assert faults.tree_checksum({"q": raw}) != \
        faults.tree_checksum({"q": raw.view(np.uint8)})


# ---------------------------------------------------------------------------
# message, partition and site faults
# ---------------------------------------------------------------------------


def _message_specs(mod):
    return dict(
        message_faults=[
            mod.MessageFault("model/latest/*", "drop", p=0.3),
            mod.MessageFault("model/latest/*", "delay", p=0.5, delay_s=1.0),
            mod.MessageFault("data/*", "reorder", p=0.5, jitter_s=0.5),
            mod.MessageFault("data/*", "duplicate", p=0.3),
            mod.MessageFault("data/*", "corrupt", p=0.4, start=5.0),
            mod.MessageFault("model/latest/*", "forge", p=0.7, end=30.0)],
        partitions=[mod.PartitionFault("edge", "cloud", 10.0, 14.0),
                    mod.PartitionFault("edge", "cloud", 20.0, 22.0,
                                       mode="drop")],
        site_faults=[mod.SiteFault("cloud", 24.0, 26.0)])


def _plan(mod, plane, model, n=40):
    """Plan ``n`` publishes on model and data topics through ``plane``:
    every delivery's time and payload, the dead letters, the events."""
    bus = types.SimpleNamespace(dead_letters=[])
    rng = np.random.default_rng(99)
    out = []
    for i in range(n):
        if i % 2:
            topic = f"model/latest/t{i % 3:02d}"
            payload = {"params": model, "checksum":
                       mod.tree_checksum(model), "window": i}
            src, dst = "cloud", "edge"
        else:
            topic = f"data/t{i % 3:02d}"
            payload = {"x": rng.random((4, 3)).astype(np.float32),
                       "window": i}
            src, dst = "edge", "cloud"
        for t, pl in plane.plan_deliveries(topic, payload, src, dst,
                                           t_pub=float(i), dt=0.05,
                                           bus=bus):
            if "params" in pl:
                got = (pl["checksum"], mod.tree_checksum(pl["params"]))
            else:
                got = np.asarray(pl["x"]).tobytes()
            out.append((topic, t, got))
    dead = [(d.topic, d.src, d.dst, d.t, d.reason) for d in bus.dead_letters]
    return out, dead, plane.schedule_signature(), dict(plane.stats)


@pytest.mark.parametrize("seed", [11, 12])
def test_plan_deliveries_equal_reference(seed):
    """Drop, delay, reorder, duplicate, corrupt and forge rules with
    windows, a queued and a dropping partition and a site crash: the
    port's plan of 40 publishes equals the reference's delivery for
    delivery (times, corrupted bytes, forged checksums), dead letter for
    dead letter and event for event; ``reset`` replays it; another seed
    plans another."""
    ours_m, ref_m = _trees(True)
    ours = faults.FaultPlane(seed, **_message_specs(faults))
    ref = ref_faults.FaultPlane(seed, **_message_specs(ref_faults))
    got = _plan(faults, ours, ours_m)
    assert got == _plan(ref_faults, ref, ref_m)
    kinds = {k for _, k, _ in got[2]}
    assert {"msg_drop", "msg_delay", "msg_reorder", "msg_duplicate",
            "msg_corrupt", "msg_forge", "partition_queued",
            "partition_drop", "lost_publish_site_down"} <= kinds
    # a forged payload's checksum is recomputed over the forged tree
    assert any(a == b != faults.tree_checksum(ours_m)
               for _, _, v in got[0] if isinstance(v, tuple) for a, b in [v])
    ours.reset()
    assert _plan(faults, ours, ours_m) == got
    other = faults.FaultPlane(seed + 10, **_message_specs(faults))
    assert _plan(faults, other, ours_m)[2] != got[2]


def test_forge_payload_recomputes_checksum():
    """``MessageFault(kind="forge")`` emits a payload whose checksum matches
    its tampered params, the reference's checksum, while its stale
    signature stays."""
    ours_m, ref_m = _trees(True)
    payloads = []
    for mod, m in ((faults, ours_m), (ref_faults, ref_m)):
        plane = mod.FaultPlane(0, message_faults=[
            mod.MessageFault("model/latest/*", "forge", p=1.0)])
        payload = {"params": m, "checksum": mod.tree_checksum(m),
                   "window": 3, "stream": "t00", "sig": "stale"}
        (t, forged), = plane.plan_deliveries(
            "model/latest/t00", payload, "cloud", "edge", t_pub=1.0,
            dt=0.05, bus=None)
        assert t == 1.05 and plane.stats["msg_forge"] == 1
        assert forged["checksum"] == mod.tree_checksum(forged["params"])
        assert forged["checksum"] != payload["checksum"]
        assert forged["sig"] == "stale" and payload["params"] is m
        payloads.append(forged)
    assert payloads[0]["checksum"] == payloads[1]["checksum"]


def test_site_faults_install_and_restart_hooks():
    """``install`` notes each crash and schedules its restart, which fires
    the registered hooks at ``t_up``; the events are the reference's."""
    events = []
    for mod, kernel_cls in ((faults, EventKernel),
                            (ref_faults, RefEventKernel)):
        plane = mod.FaultPlane(0, site_faults=[
            mod.SiteFault("cloud", 2.0, 5.0), mod.SiteFault("edge", 3.0)])
        k = kernel_cls()
        seen = []
        plane.on_restart(lambda s, k=k, seen=seen: seen.append((s, k.now)))
        plane.install(k)
        k.run()
        assert seen == [("cloud", 5.0)]
        assert plane.site_down("cloud", 2.0) and not plane.site_down(
            "cloud", 5.0)
        assert plane.site_down("edge", 1e9)
        events.append(plane.schedule_signature())
        plane.reset()
        assert plane.events == [] and not plane.stats
    assert events[0] == events[1]
    with pytest.raises(ValueError, match="pick from"):
        faults.MessageFault("x", "melt")


# ---------------------------------------------------------------------------
# sensor faults
# ---------------------------------------------------------------------------


def _sensor_specs(mod):
    return [mod.SensorFault(p_drop_window=0.2, p_dup_window=0.3,
                            p_reorder=0.5, reorder_jitter_s=1.0,
                            p_drop_record=0.2),
            mod.SensorFault(stream="t01", p_byzantine=0.6, start=2.0),
            mod.SensorFault(stream="t0[02]", p_drop_record=0.95, end=6.0)]


def _windows(mod, plane):
    rng = np.random.default_rng(5)
    out = []
    for sid in ("t00", "t01", "t02"):
        for w in range(12):
            data = {"x": rng.random((20, 5, 5)).astype(np.float32),
                    "y": rng.random((20, 1)).astype(np.float32)}
            for t, d in plane.sensor_windows(sid, w, float(w), data):
                out.append((sid, w, t, d["x"].tobytes(), d["y"].tobytes()))
    return out, plane.schedule_signature()


@pytest.mark.parametrize("seed", [5, 6])
def test_sensor_windows_equal_reference(seed):
    """Window drop, duplicate and reorder, record dropout (one window
    nearly emptied keeps a row) and Byzantine values on a subset of
    streams over a time window: the port's deliveries (times, rows,
    values) and events equal the reference's; another seed differs."""
    got = _windows(faults, faults.FaultPlane(
        seed, sensor_faults=_sensor_specs(faults)))
    want = _windows(ref_faults, ref_faults.FaultPlane(
        seed, sensor_faults=_sensor_specs(ref_faults)))
    assert got == want
    kinds = {k for _, k, _ in got[1]}
    assert {"sensor_window_drop", "sensor_window_duplicate",
            "sensor_window_reorder", "sensor_record_dropout",
            "sensor_byzantine"} <= kinds
    other = _windows(faults, faults.FaultPlane(
        seed + 2, sensor_faults=_sensor_specs(faults)))
    assert other != got
