"""Chaos scenarios: named fault-plane configurations with measured
degradation envelopes.

The port of ``src/repro/core/scenarios.py``.  Each scenario pairs a
:class:`~repro_torch.runtime.faults.FaultPlane` recipe with
the fleet pipeline (``launch.edge_cloud.build_fleet_pipeline``) under the
edge-cloud-integrated deployment and an open-loop query load, and measures
how the system *degrades* — RMSE ratio vs the fault-free run, answer-latency
tail, worst served staleness, fraction of answers from the batch-model
fallback — instead of assuming it degrades gracefully:

* ``fault_free``          — an empty fault plane; must be parity with the
  plain (no-plane) run: identical forecasts, identical dispatch counts.
* ``site_crash``          — the cloud (speed training) crashes mid-window-2
  with in-flight work lost, restarts cold at window 3.5; staleness grows
  until training resumes.
* ``partitioned_sync``    — the edge<->cloud WAN partitions for ~2 windows
  (deliveries queue until heal): model sync is delayed past the staleness
  bound, the watchdog must flip serving to the batch fallback.
* ``sensor_chaos``        — windows drop, duplicate, arrive late; records
  drop inside windows; flush timeouts + per-stream quarantine keep the
  fleet's aggregated dispatch moving.
* ``corrupted_int8_sync`` — int8 model sync with bit-flip corruption on half
  the model publishes: every corrupt publish must be checksum-detected and
  never served; re-requests recover clean copies.
* ``forged_sync``         — int8 model sync with *forged* publishes: the
  adversary perturbs the parameters and recomputes the crc32 so the
  checksum alone would accept — only the HMAC signature (health plane's
  signed sync) catches it; every forge must be rejected and re-requested.
* ``byzantine``           — sensors emit plausible-but-wrong values (offset
  by several robust sigmas, not NaN garbage): the per-stream median/MAD
  guard must flag and impute them before they reach training.
* ``compound_drift``      — no injected faults, adversarial *data*: the
  fleet mixes gradual, seasonal, abrupt, and stationary streams per stream.

All runs use ``CHAOS_STAGE_COSTS`` — fixed virtual stage walls instead of
perf-counter measurements — so the same fault seed reproduces the run
byte-for-byte (bus log, ledger, forecasts): determinism is an asserted
property, not an aspiration (see ``schedule_signature``/``bus_signature``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.runtime.faults import (
    FaultPlane,
    MessageFault,
    PartitionFault,
    SensorFault,
    SiteFault,
)

# fixed virtual wall-seconds per module: deterministic stand-ins for the
# measured stage walls, sized to the fast-mode steady-state measurements
# (training dominates; serving ticks are cheap).  Both the chaos runs AND
# the fault-free baseline use these, so RMSE parity is exact.
CHAOS_STAGE_COSTS: Dict[str, float] = {
    "batch_inference": 0.05,
    "speed_inference": 0.05,
    "hybrid_inference": 0.01,
    "speed_training": 0.5,
    "model_sync": 0.01,
    "data_sync": 0.005,
    "serving": 0.02,
    # the elastic control plane's fixed decision cost (elastic runs only;
    # chaos scenarios never enable the controller, so this key is inert
    # there — it exists so elastic runs under stage_costs replay
    # byte-for-byte too)
    "placement_controller": 0.005,
}

SCENARIOS = ("fault_free", "site_crash", "partitioned_sync", "sensor_chaos",
             "corrupted_int8_sync", "forged_sync", "byzantine",
             "compound_drift")

# per-scenario degradation envelope: max hybrid-RMSE ratio vs the fault-free
# run.  fault_free is exact parity; partition/crash must stay within the
# paper-claim bound (the watchdog serving the batch model is itself a model,
# not garbage); sensor and compound chaos change the *data*, so their
# envelopes are looser.
RMSE_RATIO_MAX: Dict[str, float] = {
    "fault_free": 1.0 + 1e-9,
    "site_crash": 1.5,
    "partitioned_sync": 1.5,
    "sensor_chaos": 2.0,
    "corrupted_int8_sync": 1.5,
    "forged_sync": 1.5,
    "byzantine": 2.5,
    "compound_drift": 3.0,
}


def scenario_plane(name: str, seed: int, period_s: float) -> FaultPlane:
    """Build the named scenario's seeded fault plane.  Times are in units
    of the window period so the faults land mid-pipeline at any period."""
    p = period_s
    if name == "fault_free" or name == "compound_drift":
        return FaultPlane(seed)
    if name == "site_crash":
        # down during window 2's training, cold restart mid-window 3
        return FaultPlane(seed, site_faults=[
            SiteFault("cloud", t_down=2.02 * p, t_up=3.5 * p)])
    if name == "partitioned_sync":
        return FaultPlane(seed, partitions=[
            PartitionFault("edge", "cloud", t_start=1.2 * p, t_heal=3.4 * p,
                           mode="queue")])
    if name == "sensor_chaos":
        return FaultPlane(seed, sensor_faults=[
            SensorFault(p_drop_window=0.15, p_dup_window=0.15, p_reorder=0.3,
                        reorder_jitter_s=0.3 * p, p_drop_record=0.1)])
    if name == "corrupted_int8_sync":
        return FaultPlane(seed, message_faults=[
            MessageFault("model/latest/*", "corrupt", p=0.5)])
    if name == "forged_sync":
        return FaultPlane(seed, message_faults=[
            MessageFault("model/latest/*", "forge", p=0.5)])
    if name == "byzantine":
        return FaultPlane(seed, sensor_faults=[
            SensorFault(p_byzantine=0.5)])
    raise ValueError(f"unknown scenario {name!r}; pick from {SCENARIOS}")


def compound_scenarios(n_streams: int) -> List[str]:
    """``compound_drift``'s per-stream drift scenarios: the cycle gradual,
    seasonal, abrupt, none (seasonal second, so even a 2-stream fleet
    exercises the excursion-and-return regime)."""
    cycle = ["gradual", "seasonal", "abrupt", "none"]
    return [cycle[i % len(cycle)] for i in range(n_streams)]


def scenario_quantized(name: str) -> bool:
    """The corruption and forgery scenarios force int8 sync: bit flips in a
    quantized tree are corruption's whole point, and forgery must prove the
    HMAC covers the int8 QTensor serialization too.  The rest inherit the
    harness default."""
    return name in ("corrupted_int8_sync", "forged_sync")


def scenario_fault_start(name: str, period_s: float) -> Optional[float]:
    """Virtual time the named scenario's connectivity fault begins — the
    reference point for measured partition/crash detection latency.  None
    for scenarios with no site/link outage."""
    if name == "site_crash":
        return 2.02 * period_s
    if name == "partitioned_sync":
        return 1.2 * period_s
    return None


# -- determinism signatures ---------------------------------------------------


def bus_signature(res) -> List[Tuple]:
    """The bus log reduced to its schedule: (topic, src, bytes, publish,
    deliver) per message, exact floats — two runs under one fault seed must
    match entry for entry."""
    return [(m.topic, m.src, float(m.nbytes), m.publish_time, m.deliver_time)
            for m in res.message_log]


def ledger_signature(res) -> Dict[str, Dict[str, float]]:
    return res.ledger.table()


def forecast_signature(res) -> List[Tuple]:
    """Per-stream window forecasts (+ served query answers), excluding the
    measured host walls (t_*) which are not part of the deterministic
    contract."""
    sig: List[Tuple] = []
    for sid in sorted(res.results):
        for r in res.results[sid].records:
            sig.append((sid, r.window, r.rmse_batch, r.rmse_speed,
                        r.rmse_hybrid, r.w_speed))
    for q in res.queries:
        sig.append((q.stream, q.uid, tuple(q.answer), q.model_window,
                    q.context_window, q.served_fallback))
    return sig


def scenario_envelope(name: str, seed: int, res, period_s: float
                      ) -> Dict[str, Any]:
    """A scenario run's degradation envelope: the hybrid RMSE, windows
    scored, fleet fits, the request plane's answered and starved counts,
    p99 latency, worst served staleness and fallback share, capacity
    failures and dead letters; under a fault plane its counts, rejections,
    re-requests and quarantines; under a health plane its verdicts, the
    Byzantine guard's counters, the threshold adaptations and, for a
    connectivity fault, the detection latency."""
    s = res.serving or {}
    env = {
        "scenario": name,
        "seed": seed,
        "unhandled_exception": None,
        "rmse_hybrid": res.mean_rmse()["hybrid"],
        "n_windows_scored": sum(len(r.records)
                                for r in res.results.values()),
        "train_dispatches": res.train_dispatches,
        "n_answered": s.get("n_answered", 0),
        "n_starved": s.get("n_starved", 0),
        "p99_latency_s": s.get("p99_s", float("inf")),
        "max_staleness": s.get("max_staleness", 0),
        "fallback_frac": s.get("fallback_frac", 0.0),
        "capacity_failures": len(res.failures),
        "dead_letters": len(res.dead_letters),
    }
    if res.chaos is not None:
        env["fault_stats"] = res.chaos["fault_stats"]
        env["n_fault_events"] = res.chaos["n_fault_events"]
        env["corrupt_rejected"] = res.chaos["corrupt_rejected"]
        env["checksum_verified"] = res.chaos["checksum_verified"]
        env["resync_requests"] = res.chaos["resync_requests"]
        env["quarantined"] = res.chaos["quarantined"]
        env["forged_rejected"] = res.chaos.get("forged_rejected", 0)
    h = getattr(res, "health", None)
    if h is not None:
        env["health"] = {
            "signed_sync": h["signed_sync"],
            "adaptive": h["adaptive"],
            "n_suspected": h["n_suspected"],
            "n_site_down": h["n_site_down"],
            "n_recovered": h["n_recovered"],
            "first_suspect_t": h["first_suspect_t"],
            "hb_interval_s": h["hb_interval_s"],
            "byz_screened": h["byz_screened"],
            "byz_flagged": h["byz_flagged"],
            "threshold_adaptations": h["threshold_adaptations"],
            "adapted_quarantine_after": h["adapted_quarantine_after"],
            "adapted_staleness_bound": h["adapted_staleness_bound"],
        }
        t0 = scenario_fault_start(name, period_s)
        if t0 is not None and h["first_suspect_t"] is not None:
            env["health"]["detection_latency_s"] = (
                h["first_suspect_t"] - t0)
            env["health"]["detection_latency_hb_intervals"] = (
                (h["first_suspect_t"] - t0) / h["hb_interval_s"])
    return env


class ChaosHarness:
    """Build the fleet pipeline once, run it under any scenario's fault
    plane.

    The pretrained batch model and stage set are shared across scenarios
    (stream history is drift-independent by construction,
    ``fleet_windowed_streams`` starts drift where the live stream starts, so
    one pretrain serves every stream-scenario mix, including
    ``compound_drift``'s per-stream gradual/seasonal/abrupt/none cycle).

    Every scenario run carries the self-diagnosing health plane
    (``runtime.health.HealthPlane``): heartbeat partition detection, signed
    model sync, the Byzantine value guard, and adaptive fault thresholds.
    ``run_scenario(..., adaptive=False)`` swaps in a static-threshold plane
    so the adaptive path can be proven byte-identical when no faults fire.
    ``run_plain`` stays plane-less, the parity reference.

    Everything runs on ``device`` (the current CUDA device by default); the
    run key is the integer ``run_key``, where the reference has
    ``PRNGKey(1)``."""

    run_key = 1

    def __init__(self, *, n_streams: int = 3, n_windows: int = 6,
                 records_per_window: int = 120, period_s: float = 5.0,
                 qps: float = 8.0, serve_slots: int = 4,
                 staleness_bound: int = 1, base_scenario: str = "gradual",
                 verbose: bool = False, device=None):
        from repro_torch.launch.edge_cloud import build_fleet_pipeline
        from repro_torch.runtime.health import HealthConfig, HealthPlane

        self.n_streams = n_streams
        self.n_windows = n_windows
        self.rpw = records_per_window
        self.period = period_s
        self.qps = qps
        self.serve_slots = serve_slots
        self.staleness_bound = staleness_bound
        self.base_scenario = base_scenario
        self.health = HealthPlane(HealthConfig())
        self.health_static = HealthPlane(HealthConfig(adaptive=False))
        self.stages, self.bp, self._base_streams, self.cost = \
            build_fleet_pipeline(n_streams, n_windows, fast=True,
                                 records_per_window=records_per_window,
                                 scenario=base_scenario, verbose=verbose,
                                 device=device)
        self._compound_streams = None

    def streams_for(self, name: str):
        if name != "compound_drift":
            return self._base_streams
        if self._compound_streams is None:
            from repro_torch.streams.sources import fleet_windowed_streams

            self._compound_streams, _ = fleet_windowed_streams(
                self.n_streams, self.n_windows, self.rpw,
                compound_scenarios(self.n_streams),
                alphas=np.full(5, 1.5e-3))
        return self._compound_streams

    def executor(self, fault_plane: Optional[FaultPlane],
                 quantized: bool = False, health_plane=None):
        from repro_torch.runtime import FleetBusExecutor, paper_topology
        from repro_torch.runtime.deployment import edge_cloud_integrated

        return FleetBusExecutor(
            self.stages, edge_cloud_integrated(), paper_topology(),
            self.cost, window_period_s=self.period, qps=self.qps,
            serve_slots=self.serve_slots, quantized_sync=quantized,
            fault_plane=fault_plane, stage_costs=dict(CHAOS_STAGE_COSTS),
            staleness_bound=self.staleness_bound,
            health_plane=health_plane)

    def run_plain(self):
        """The non-chaos reference path: no fault plane at all (the bus
        publish fast path, no flush timers) but the same deterministic
        stage costs, what ``fault_free`` must be parity with."""
        ex = self.executor(None)
        return ex.run(self._base_streams, self.bp, self.run_key)

    def run_scenario(self, name: str, seed: int = 0, adaptive: bool = True
                     ) -> Tuple[Dict[str, Any], Any]:
        """Run one scenario; returns (envelope, FleetBusRunResult).  Any
        exception is itself a failed envelope (``unhandled_exception``):
        chaos must degrade the numbers, never crash the runtime."""
        plane = scenario_plane(name, seed, self.period)
        hp = self.health if adaptive else self.health_static
        ex = self.executor(plane, quantized=scenario_quantized(name),
                           health_plane=hp)
        try:
            res = ex.run(self.streams_for(name), self.bp, self.run_key)
        except Exception as e:  # noqa: BLE001 - the envelope records it
            return {"scenario": name, "seed": seed,
                    "unhandled_exception": f"{type(e).__name__}: {e}"}, None
        env = self.envelope(name, seed, res)
        return env, res

    def envelope(self, name: str, seed: int, res) -> Dict[str, Any]:
        return scenario_envelope(name, seed, res, self.period)
