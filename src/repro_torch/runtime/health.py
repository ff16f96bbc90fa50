"""The health plane: the self-diagnosing half of fault tolerance.

The port of ``src/repro/runtime/health.py``.  The chaos plane
(``runtime.faults``) shows the runtime rides out partitions, crashes and
corrupted sync; this module makes it name them.  A :class:`HealthPlane`
runs inside the bus runtime (``FleetBusExecutor(health_plane=...)``) and
turns the fault plane's injected failures into detected, attributed,
adaptively handled ones, in four pieces:

* **goldpinger-style partition detection**: every site publishes periodic
  heartbeats on ``health/hb/<site>``, and every site runs a
  :class:`SiteMonitor` that tracks each peer's inter-arrival times with a
  phi-accrual-style suspicion score and emits ``partition_suspected``,
  ``site_down`` and ``recovered`` verdicts.  With two sites a monitor
  cannot tell "the WAN is cut" from "the peer died", so suspicion escalates
  (suspected, then down) and the verdict log records who observed whom.
* **authenticated model sync**: HMAC-SHA256 signatures (:func:`sign_tree`,
  keyed per run by :func:`derive_sync_key`) over the serialization
  ``tree_checksum`` digests.  CRC32 detects corruption but not tampering (a
  forger recomputes it; ``MessageFault(kind="forge")`` does exactly that);
  the HMAC needs the run key, so ``ModelSync`` rejects every forged publish
  and the executor's re-request path recovers.
* **Byzantine-value defense**: :class:`ByzantineGuard`, a per-stream
  rolling median/MAD plausibility gate in the injection path; plausible
  but wrong sensor values (``SensorFault.p_byzantine``) are flagged and
  imputed with the rolling median before the window reaches the bus.
  Clean data passes through as the same array objects.
* **adaptive fault thresholds**: :class:`FaultRateEstimator` keeps an
  exponentially decayed fault count per link and per stream from every
  detection above; ``quarantine_after`` and the staleness watchdog's bound
  become functions of that pressure.  Calm runs see exactly the base values
  (bit-identical to static thresholds); rising fault rates tighten both.

Everything here is plain Python and numpy, with no RNG and virtual-time
arithmetic only, so health-plane runs replay byte for byte under one fault
seed.  ``sign_tree`` digests what the reference's digests, in the same
leaf order (``serving.quantize.tree_leaves``), so the same tree gives the
reference's hex digest.
"""
from __future__ import annotations

import hashlib
import hmac
import math
from collections import Counter, deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serving.quantize import tree_leaves
from repro_torch.stacked import host_params

LN2 = math.log(2.0)


def derive_sync_key(seed: int) -> bytes:
    """The run's model-sync signing key.  Deterministically derived from the
    run seed so reruns replay byte-for-byte; in a real deployment this is
    the provisioning secret both ends of the sync channel hold (the fault
    plane's forger, by construction, does not)."""
    return hashlib.sha256(f"model-sync-key:{int(seed)}".encode()).digest()


def sign_tree(tree: Any, key: bytes) -> str:
    """HMAC-SHA256 over a params tree: every leaf's shape, dtype and bytes
    in ``tree_leaves`` order, the authenticated analog of
    ``tree_checksum``; an int8 ``QTensor`` signs as its ``q`` then its
    ``scale``, a ``FleetParamView`` as its slice of the fleet's host copy.
    Unlike CRC32, a forger cannot recompute it without ``key``."""
    mac = hmac.new(key, digestmod=hashlib.sha256)
    for leaf in tree_leaves(host_params(tree)):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        a = np.ascontiguousarray(np.asarray(leaf))
        mac.update(repr((a.shape, a.dtype.str)).encode())
        mac.update(a.tobytes())
    return mac.hexdigest()


def verify_tree(tree: Any, key: bytes, signature: Optional[str]) -> bool:
    if not signature:
        return False
    return hmac.compare_digest(sign_tree(tree, key), signature)


@dataclass
class HealthConfig:
    """Health-plane knobs.  Defaults are sized so a calm run is
    byte-identical to a no-health run and detection stays within two
    heartbeat intervals of an injected partition."""

    # heartbeat cadence; None -> the executor uses 0.5 * window period
    hb_interval_s: Optional[float] = None
    # phi-accrual-style suspicion thresholds: elapsed / mean inter-arrival
    phi_suspect: float = 1.4
    phi_down: float = 3.2
    interarrival_window: int = 16
    # Byzantine guard: flag |y - median| > byz_z * MAD-sigma of the rolling
    # per-stream history; engage only once min_history values are seen
    byz_z: float = 5.0
    byz_history: int = 720
    byz_min_history: int = 48
    # authenticated sync: HMAC-SHA256 over every model publish
    signed_sync: bool = True
    # adaptive thresholds: decayed-fault-count halflife (seconds; None ->
    # 2 * window period) and the pressure below which base values apply
    adaptive: bool = True
    rate_halflife_s: Optional[float] = None
    # decayed-fault-count level below which base thresholds apply exactly;
    # 1.5 means one isolated fault never tightens anything — it takes a
    # second fault inside the halflife to register as a *rate*
    calm_pressure: float = 1.5
    staleness_floor: int = 0
    quarantine_floor: int = 1


class FaultRateEstimator:
    """Exponentially-decayed fault counter: ``count(t) = sum over observed
    faults of 0.5 ** ((t - t_i) / halflife)`` — the health plane's fault-
    rate estimate (EWMA in count units, so thresholds read naturally as
    "recent faults")."""

    def __init__(self, halflife_s: float):
        self.halflife = float(halflife_s)
        self._count = 0.0
        self._t = 0.0

    def _decay_to(self, t: float) -> None:
        dt = max(0.0, t - self._t)
        if dt > 0.0 and self._count > 0.0:
            self._count *= math.exp(-LN2 * dt / self.halflife)
        self._t = max(self._t, t)

    def observe(self, t: float, n: float = 1.0) -> None:
        self._decay_to(t)
        self._count += n

    def pressure(self, t: float) -> float:
        self._decay_to(t)
        return self._count


class PhiAccrual:
    """Per-peer inter-arrival tracker.  ``phi(t) = elapsed / mean`` where
    ``mean`` is the windowed mean inter-arrival time (falling back to the
    expected heartbeat interval until a sample exists).  Intervals observed
    while the peer is suspected/down — and burst arrivals released together
    by a healing partition — are excluded from the mean, so an outage never
    poisons the baseline it is judged against."""

    def __init__(self, expected_s: float, window: int):
        self.expected = float(expected_s)
        self.intervals: deque = deque(maxlen=window)
        self.last_seen: Optional[float] = None

    def mean(self) -> float:
        if not self.intervals:
            return self.expected
        return float(sum(self.intervals) / len(self.intervals))

    def arrive(self, t: float, healthy: bool) -> None:
        if self.last_seen is not None and healthy:
            gap = t - self.last_seen
            # burst arrivals (a healed partition releasing the queue) and
            # the outage gap itself are not cadence samples
            if 0.25 * self.expected <= gap <= 2.0 * self.expected:
                self.intervals.append(gap)
        self.last_seen = max(self.last_seen or t, t)

    def phi(self, t: float) -> float:
        if self.last_seen is None:
            return 0.0
        return max(0.0, t - self.last_seen) / max(self.mean(), 1e-9)


class SiteMonitor:
    """One site's view of every peer — the goldpinger node.  State machine
    per peer: ok -> suspected -> down, back to ok on the next heartbeat
    (emitting ``recovered``).  A monitor that itself went dark (its check
    beat did not run — its site was down) re-baselines instead of blaming
    peers for heartbeats it was not alive to receive."""

    def __init__(self, observer: str, peers: List[str], cfg: HealthConfig,
                 hb_interval_s: float, plane: "HealthPlane"):
        self.observer = observer
        self.cfg = cfg
        self.hb = hb_interval_s
        self.plane = plane
        self.trackers: Dict[str, PhiAccrual] = {
            p: PhiAccrual(hb_interval_s, cfg.interarrival_window)
            for p in peers if p != observer}
        self.state: Dict[str, str] = {p: "ok" for p in self.trackers}
        self.last_check: Optional[float] = None

    def observe_heartbeat(self, peer: str, t: float) -> None:
        tr = self.trackers.get(peer)
        if tr is None:
            return
        healthy = self.state[peer] == "ok"
        tr.arrive(t, healthy)
        if not healthy:
            self.state[peer] = "ok"
            self.plane.verdict(t, "recovered", self.observer, peer,
                               f"hb after {self.state}")

    def check(self, t: float) -> None:
        if self.last_check is not None and t - self.last_check > 1.5 * self.hb:
            # the monitor itself was dark (its site was down): re-baseline
            # every peer instead of emitting stale-evidence verdicts
            self.plane.verdict(t, "monitor_gap", self.observer, self.observer,
                               f"{t - self.last_check:.3f}s without checks")
            for tr in self.trackers.values():
                tr.last_seen = t
            self.last_check = t
            return
        self.last_check = t
        for peer, tr in self.trackers.items():
            phi = tr.phi(t)
            st = self.state[peer]
            if st == "ok" and phi >= self.cfg.phi_suspect:
                self.state[peer] = "suspected"
                self.plane.verdict(t, "partition_suspected", self.observer,
                                   peer, f"phi={phi:.2f}")
            if st in ("ok", "suspected") and phi >= self.cfg.phi_down:
                self.state[peer] = "down"
                self.plane.verdict(t, "site_down", self.observer, peer,
                                   f"phi={phi:.2f}")


class ByzantineGuard:
    """Per-stream robust plausibility gate for sensor target values: flag
    ``|y - median| > z * (1.4826 * MAD)`` of the stream's rolling accepted
    history and impute the rolling median.  History updates with the
    *imputed* values, so admitted Byzantine values cannot drag the baseline
    toward themselves.  Returns the original arrays untouched when nothing
    is flagged — calm-path byte-identity."""

    def __init__(self, cfg: HealthConfig):
        self.cfg = cfg
        self._hist: Dict[str, deque] = {}
        self.flagged: Counter = Counter()
        self.screened = 0

    def screen(self, sid: str, data: Dict[str, np.ndarray], t: float
               ) -> Tuple[Dict[str, np.ndarray], int]:
        y = np.asarray(data["y"])
        hist = self._hist.setdefault(sid, deque(maxlen=self.cfg.byz_history))
        self.screened += int(y.size)
        n_flagged = 0
        if len(hist) >= self.cfg.byz_min_history and y.size > 0:
            h = np.asarray(hist, np.float64)
            med = float(np.median(h))
            sigma = 1.4826 * float(np.median(np.abs(h - med))) + 1e-9
            dev = np.abs(y.reshape(-1) - med) / sigma
            bad = dev > self.cfg.byz_z
            n_flagged = int(bad.sum())
            if n_flagged:
                self.flagged[sid] += n_flagged
                y2 = np.array(y, copy=True)
                y2.reshape(-1)[bad] = np.float32(med)
                hist.extend(float(v) for v in y2.reshape(-1))
                return {"x": data["x"], "y": y2}, n_flagged
        hist.extend(float(v) for v in y.reshape(-1))
        return data, 0


class HealthPlane:
    """The umbrella object the executor attaches: per-site monitors, the
    Byzantine guard, the fault-rate estimators and the adaptive-threshold
    policy, plus the signed-sync configuration.  ``reset()`` (called by the
    executor per run, like ``FaultPlane.reset``) rewinds all of it so one
    plane instance drives repeated byte-identical runs."""

    def __init__(self, cfg: Optional[HealthConfig] = None):
        self.cfg = cfg or HealthConfig()
        self._bound = False
        self.reset()

    # -- lifecycle -----------------------------------------------------------

    def reset(self) -> None:
        self.monitors: Dict[str, SiteMonitor] = {}
        self.guard = ByzantineGuard(self.cfg)
        self.verdicts: List[Tuple[float, str, str, str, str]] = []
        self.verdict_stats: Counter = Counter()
        self._rates: Dict[Tuple[str, str], FaultRateEstimator] = {}
        self.adaptations: List[Tuple[float, str, str, int, int]] = []
        self._last_eff: Dict[Tuple[str, str], int] = {}
        self.sync_key: Optional[bytes] = None
        self._hb = 0.0
        self._halflife = 1.0
        self._base_quarantine = 0
        self._base_staleness = 0

    def bind(self, *, sites: List[str], hb_interval_s: float,
             halflife_s: float, quarantine_after: int,
             staleness_bound: int, sync_seed: int) -> None:
        """Per-run wiring (executor ``_reset`` time): build one monitor per
        site over the run's topology, fix the decay clock, and remember the
        executor's base thresholds — the values calm runs must reproduce
        exactly."""
        self._hb = float(hb_interval_s)
        self._halflife = float(halflife_s)
        self._base_quarantine = int(quarantine_after)
        self._base_staleness = int(staleness_bound)
        self.monitors = {
            s: SiteMonitor(s, sites, self.cfg, self._hb, self)
            for s in sites}
        self.sync_key = (derive_sync_key(sync_seed)
                         if self.cfg.signed_sync else None)

    # -- detection -----------------------------------------------------------

    def verdict(self, t: float, kind: str, observer: str, subject: str,
                detail: str = "") -> None:
        self.verdicts.append((float(t), kind, observer, subject, detail))
        self.verdict_stats[kind] += 1
        if kind in ("partition_suspected", "site_down"):
            self.observe_fault("link", subject, t)

    def observe_heartbeat(self, observer: str, peer: str, t: float) -> None:
        mon = self.monitors.get(observer)
        if mon is not None:
            mon.observe_heartbeat(peer, t)

    def check(self, observer: str, t: float) -> None:
        mon = self.monitors.get(observer)
        if mon is not None:
            mon.check(t)

    def first_verdict_t(self, kind: str) -> Optional[float]:
        for t, k, _, _, _ in self.verdicts:
            if k == kind:
                return t
        return None

    # -- fault pressure + adaptive thresholds --------------------------------

    def observe_fault(self, kind: str, key: str, t: float) -> None:
        """Feed one detected fault into the rate estimate: ``kind`` in
        {"link", "sync", "sensor"}, ``key`` the subject site or stream."""
        est = self._rates.get((kind, key))
        if est is None:
            est = self._rates[(kind, key)] = FaultRateEstimator(
                self._halflife)
        est.observe(t)

    def pressure(self, kind: str, key: str, t: float) -> float:
        est = self._rates.get((kind, key))
        return est.pressure(t) if est is not None else 0.0

    def _adapt(self, t: float, which: str, key: str, base: int,
               pressure: float, floor: int) -> int:
        if not self.cfg.adaptive or pressure < self.cfg.calm_pressure:
            return base
        eff = max(floor, base - int(pressure / self.cfg.calm_pressure))
        if eff != base and self._last_eff.get((which, key)) != eff:
            self._last_eff[(which, key)] = eff
            self.adaptations.append((float(t), which, key, base, eff))
        return eff

    def quarantine_after(self, sid: str, t: float) -> int:
        """How many consecutive missed training flushes quarantine ``sid``
        right now: the base knob under calm pressure, tightened (never
        below ``quarantine_floor``) as this stream's detected sensor+sync
        fault pressure rises — a flaky sensor is cut out of the aggregation
        path faster than a healthy fleet's worst-case straggler would be."""
        p = (self.pressure("sensor", sid, t)
             + self.pressure("sync", sid, t))
        return self._adapt(t, "quarantine_after", sid,
                           self._base_quarantine, p,
                           self.cfg.quarantine_floor)

    def staleness_bound(self, sid: str, t: float) -> int:
        """The serving watchdog's model-lag bound for ``sid`` right now:
        the base bound under calm pressure, tightened toward
        ``staleness_floor`` when the sync path is visibly failing (link
        suspicion anywhere, or this stream's sync rejections) — serving
        flips to the batch fallback sooner exactly when fresh models are
        least likely to arrive."""
        link_p = max((est.pressure(t)
                      for (k, _), est in self._rates.items() if k == "link"),
                     default=0.0)
        p = link_p + self.pressure("sync", sid, t)
        return self._adapt(t, "staleness_bound", sid,
                           self._base_staleness, p,
                           self.cfg.staleness_floor)

    # -- reporting -----------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        """The run's health verdict, attached as
        ``FleetBusRunResult.health``."""
        min_q: Dict[str, int] = {}
        min_s: Dict[str, int] = {}
        for _, which, key, _, eff in self.adaptations:
            d = min_q if which == "quarantine_after" else min_s
            d[key] = min(d.get(key, eff), eff)
        return {
            "hb_interval_s": self._hb,
            "signed_sync": self.cfg.signed_sync,
            "adaptive": self.cfg.adaptive,
            "verdicts": [list(v) for v in self.verdicts],
            "verdict_stats": dict(self.verdict_stats),
            "n_suspected": self.verdict_stats.get("partition_suspected", 0),
            "n_site_down": self.verdict_stats.get("site_down", 0),
            "n_recovered": self.verdict_stats.get("recovered", 0),
            "first_suspect_t": self.first_verdict_t("partition_suspected"),
            "byz_screened": self.guard.screened,
            "byz_flagged": sum(self.guard.flagged.values()),
            "byz_flagged_per_stream": dict(self.guard.flagged),
            "threshold_adaptations": len(self.adaptations),
            "adapted_quarantine_after": min_q,
            "adapted_staleness_bound": min_s,
            "base_quarantine_after": self._base_quarantine,
            "base_staleness_bound": self._base_staleness,
        }
