"""Elastic fleet placement: queue-driven migration + predictive autoscaling.

Since the fleet executors made placement a *per-stream* decision (per-stream
``stream/window/<sid>`` topics under a ``Deployment``), every stream has
nevertheless lived wherever the deployment statically pinned it.  This module
closes the loop: a :class:`PlacementController` runs as a periodic bus
subscriber inside ``FleetBusExecutor`` and makes three decisions per control
interval, from signals the runtime already produces:

* **per-stream migration** — hot streams (drifting per the ``DriftGate``
  retrain log, or queued behind a saturated site per the ``LatencyLedger``
  backlog series) are pinned to a cloud site; cold/stationary streams are
  demoted back to edge.  The executor applies a migration by republishing
  the stream's topic subscriptions at the new site and handing its
  device-resident state across stream-count buckets
  (``FleetState.handoff``) — the aggregated one-dispatch-per-window
  train/predict path is untouched because aggregation happens *above*
  placement.
* **reactive scaling** — ``Site.workers`` grows/shrinks from an EWMA of
  per-worker queue backlog, with hysteresis: separate up/down thresholds,
  a persistence requirement, and a cooldown between changes, so an
  oscillating load cannot flap the worker count.
* **proactive scaling** — the recent per-site load series feeds a small
  speed-layer :class:`LoadForecaster` (the same compile-once
  ``CompiledForecaster`` hot path the fleet trains on, one feature wide);
  when the *forecast* backlog crosses the scale-up threshold the site
  scales ahead of the spike instead of after it.

The controller is a pure policy object: ``step(t, sites, streams)`` consumes
:class:`SiteSignal`/:class:`StreamSignal` snapshots and returns a
:class:`PlacementDecision`; the executor owns signal collection and decision
application.  Everything is deterministic — decisions depend only on the
signal history and a fixed integer key — so elastic runs replay
byte-for-byte.

The signals, the decisions and the controller's policy are copied from the
reference (pure Python and numpy): the same signals give the same decisions
in both packages.  Only :class:`LoadForecaster` differs, riding the port's
trainer on the card.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device


# ---------------------------------------------------------------------------
# Signals (executor -> controller) and decisions (controller -> executor)
# ---------------------------------------------------------------------------


@dataclass
class SiteSignal:
    """One site's load snapshot at a control tick."""

    name: str
    kind: str  # "edge" | "cloud"
    workers: int
    base_workers: int
    backlog_s: float  # seconds of admitted-but-unfinished work on the site


@dataclass
class StreamSignal:
    """One stream's placement-relevant snapshot at a control tick."""

    sid: str
    site: str  # site currently serving the stream's inference chain
    drift_hot: float  # fraction of recent windows the DriftGate retrained
    queue_s: float  # backlog at the stream's site (per-stream queue proxy)


@dataclass
class PlacementDecision:
    """What one control tick decided.  Empty dicts mean steady state."""

    t: float
    migrations: Dict[str, str] = field(default_factory=dict)  # sid -> site
    workers: Dict[str, int] = field(default_factory=dict)  # site -> count
    notes: List[str] = field(default_factory=list)

    def empty(self) -> bool:
        return not self.migrations and not self.workers


# ---------------------------------------------------------------------------
# Proactive load forecasting with the speed layer itself
# ---------------------------------------------------------------------------


class LoadForecaster:
    """Forecast the next per-site load sample with the speed layer itself: a
    small LSTM (``lstm-paper`` cut to ``hidden`` units, Dense(4), one
    feature, ``lag`` steps) fitted through the port's compile-once trainer
    (``CompiledForecaster``, each step one launch of each LSTM training
    kernel) on ``device``, the current CUDA device unless the caller names
    one.  The history length is clamped, so every fit has one shape bucket.

    The LSTM fit is floored by a linear trend extrapolation: a ramp the tiny
    model has not yet learned must still be seen coming, which is the whole
    point of scaling *ahead*.  ``forecast`` is deterministic: every fit is a
    cold start from the integer key ``seed``, on data alone.

    The reference draws that fit's init and permutations from
    ``jax.random.PRNGKey(seed)``; the port draws them from
    ``torch.Generator().manual_seed(seed)`` as its trainer draws every key,
    so the two packages' fits differ.  The parity tests replay the
    reference's draws through the fit (``_forecaster().train``)."""

    def __init__(self, *, lag: int = 4, hidden: int = 8, epochs: int = 6,
                 history: int = 16, horizon: int = 2, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None):
        self.lag = int(lag)
        self.hidden = int(hidden)
        self.epochs = int(epochs)
        self.history = int(history)
        self.horizon = int(horizon)
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.fits = 0
        self._fc = None  # built at the first fit

    # -- internals ----------------------------------------------------------

    def _forecaster(self):
        if self._fc is None:
            from repro_torch.configs import get_config
            from repro_torch.configs.base import LSTMConfig
            from repro_torch.core.hybrid import lstm_forecaster

            cfg = get_config("lstm-paper").replace(
                name="lstm-load",
                lstm=LSTMConfig(hidden=self.hidden, dense=4, n_features=1,
                                lag=self.lag, out_dim=1))
            self._fc = lstm_forecaster(cfg, epochs=self.epochs,
                                       batch_size=16, device=self.device)
        return self._fc

    @staticmethod
    def _trend(series: np.ndarray, horizon: int) -> float:
        """Least-squares linear extrapolation ``horizon`` steps ahead."""
        n = len(series)
        t = np.arange(n, dtype=np.float64)
        slope, intercept = np.polyfit(t, np.asarray(series, np.float64), 1)
        return float(intercept + slope * (n - 1 + horizon))

    # -- API ----------------------------------------------------------------

    def min_history(self) -> int:
        return self.lag + 2

    def forecast(self, series: Sequence[float]) -> float:
        """Predicted load ``horizon`` control ticks ahead (clamped >= 0)."""
        from repro_torch.core.windows import make_supervised

        s = np.asarray(series, np.float32)[-self.history:]
        if len(s) < self.min_history():
            return float(s[-1]) if len(s) else 0.0
        scale = float(np.max(np.abs(s)))
        trend = self._trend(s, self.horizon)
        if scale <= 1e-9:
            return max(0.0, trend)
        data = make_supervised(s[:, None] / scale, self.lag)
        fc = self._forecaster()
        params, _ = fc.train(data, None, self.seed)
        x = (s[-self.lag:, None] / scale)[None, :, :]
        pred = float(np.asarray(fc.predict(params, x)).reshape(-1)[0]) * scale
        self.fits += 1
        return max(0.0, max(pred, trend))


# ---------------------------------------------------------------------------
# The controller
# ---------------------------------------------------------------------------


@dataclass
class _SiteCtl:
    ewma: float = 0.0
    up_streak: int = 0
    down_streak: int = 0
    last_change: int = -(10 ** 9)
    history: List[float] = field(default_factory=list)


@dataclass
class _StreamCtl:
    hot_streak: int = 0
    cold_streak: int = 0
    last_move: int = -(10 ** 9)


class PlacementController:
    """Three decisions per control tick: migrate, scale reactively, scale
    proactively.  All thresholds are on *per-worker backlog seconds* (site
    backlog divided by worker count), so a site that scales up immediately
    looks less loaded to every later decision.

    Hysteresis constants (the no-flapping contract):

    * ``scale_up_s`` > ``scale_down_s`` — a dead band between the grow and
      shrink thresholds;
    * ``persistence`` — the threshold must hold for this many consecutive
      ticks before anything moves;
    * ``cooldown`` — minimum ticks between two worker changes on one site;
    * ``min_residency`` — minimum ticks a stream stays put after migrating.

    A proactive controller built without a ``forecaster`` makes its own
    :class:`LoadForecaster` on ``device`` (the current CUDA device unless
    named).
    """

    def __init__(self, *, proactive: bool = True,
                 ewma_alpha: float = 0.5,
                 scale_up_s: float = 0.5, scale_down_s: float = 0.05,
                 persistence: int = 2, cooldown: int = 2,
                 max_workers: int = 8,
                 migrate_up_s: float = 0.5, migrate_down_s: float = 0.05,
                 hot_drift_frac: float = 0.6, cold_drift_frac: float = 0.2,
                 min_residency: int = 4,
                 max_migrations_per_tick: int = 2,
                 forecaster: Optional[LoadForecaster] = None,
                 seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None):
        if scale_up_s <= scale_down_s or migrate_up_s <= migrate_down_s:
            raise ValueError("hysteresis requires up threshold > down")
        self.proactive = proactive
        self.ewma_alpha = ewma_alpha
        self.scale_up_s = scale_up_s
        self.scale_down_s = scale_down_s
        self.persistence = max(1, int(persistence))
        self.cooldown = max(0, int(cooldown))
        self.max_workers = int(max_workers)
        self.migrate_up_s = migrate_up_s
        self.migrate_down_s = migrate_down_s
        self.hot_drift_frac = hot_drift_frac
        self.cold_drift_frac = cold_drift_frac
        self.min_residency = max(0, int(min_residency))
        self.max_migrations_per_tick = int(max_migrations_per_tick)
        self.forecaster = (LoadForecaster(seed=seed, device=device)
                           if proactive and forecaster is None
                           else forecaster)
        self.tick = 0
        self.events: List[Dict[str, Any]] = []
        self._sites: Dict[str, _SiteCtl] = {}
        self._streams: Dict[str, _StreamCtl] = {}

    # -- helpers ------------------------------------------------------------

    @staticmethod
    def _target(sites: Sequence[SiteSignal], kind: str) -> Optional[str]:
        for s in sites:
            if s.kind == kind:
                return s.name
        return None

    def _note(self, t: float, kind: str, **detail) -> None:
        self.events.append({"t": float(t), "event": kind, **detail})

    # -- the policy ---------------------------------------------------------

    def step(self, t: float, sites: Sequence[SiteSignal],
             streams: Sequence[StreamSignal]) -> PlacementDecision:
        self.tick += 1
        dec = PlacementDecision(t=t)

        # --- per-site load bookkeeping + scaling -------------------------
        per_worker: Dict[str, float] = {}
        for s in sites:
            ctl = self._sites.setdefault(s.name, _SiteCtl())
            load = s.backlog_s / max(s.workers, 1)
            per_worker[s.name] = load
            a = self.ewma_alpha
            ctl.ewma = (1.0 - a) * ctl.ewma + a * load
            ctl.history.append(load)
            ctl.up_streak = ctl.up_streak + 1 if ctl.ewma > self.scale_up_s \
                else 0
            ctl.down_streak = (ctl.down_streak + 1
                               if ctl.ewma < self.scale_down_s else 0)

            cooled = self.tick - ctl.last_change >= self.cooldown
            new_workers = s.workers
            trigger = None
            if (ctl.up_streak >= self.persistence and cooled
                    and s.workers < self.max_workers):
                new_workers, trigger = s.workers + 1, "reactive-up"
            elif (self.proactive and self.forecaster is not None and cooled
                    and s.workers < self.max_workers
                    and len(ctl.history)
                    >= self.forecaster.min_history()):
                fcast = self.forecaster.forecast(ctl.history)
                if fcast > self.scale_up_s:
                    new_workers, trigger = s.workers + 1, "proactive-up"
                    self._note(t, "forecast", site=s.name, value=fcast)
            if (trigger is None and ctl.down_streak >= self.persistence
                    and cooled and s.workers > s.base_workers):
                new_workers, trigger = s.workers - 1, "reactive-down"
            if trigger is not None:
                dec.workers[s.name] = new_workers
                ctl.last_change = self.tick
                self._note(t, "scale", site=s.name, workers_from=s.workers,
                           workers_to=new_workers, trigger=trigger,
                           ewma=round(ctl.ewma, 6))

        # --- per-stream migration ----------------------------------------
        # deepest per-stream queue first: when the per-tick migration cap
        # bites, the streams actually responsible for the backlog move
        # first (stable sort keeps fleet order on ties — deterministic)
        cloud = self._target(sites, "cloud")
        edge = self._target(sites, "edge")
        for st in sorted(streams, key=lambda s: -s.queue_s):
            ctl = self._streams.setdefault(st.sid, _StreamCtl())
            site_ewma = self._sites.setdefault(st.site, _SiteCtl()).ewma
            hot = (st.drift_hot >= self.hot_drift_frac
                   or site_ewma > self.migrate_up_s)
            cold = (st.drift_hot <= self.cold_drift_frac
                    and site_ewma <= self.migrate_down_s)
            ctl.hot_streak = ctl.hot_streak + 1 if hot else 0
            ctl.cold_streak = ctl.cold_streak + 1 if cold else 0
            if len(dec.migrations) >= self.max_migrations_per_tick:
                continue
            resident = self.tick - ctl.last_move >= self.min_residency
            target = None
            if (hot and cloud is not None and st.site != cloud
                    and ctl.hot_streak >= self.persistence and resident):
                target, why = cloud, "hot"
            elif (cold and edge is not None and st.site != edge
                    and ctl.cold_streak >= self.persistence and resident
                    and self._sites.setdefault(edge, _SiteCtl()).ewma
                    <= self.migrate_down_s):
                target, why = edge, "cold"
            if target is not None:
                dec.migrations[st.sid] = target
                ctl.last_move = self.tick
                ctl.hot_streak = ctl.cold_streak = 0
                self._note(t, "migrate", sid=st.sid, site_from=st.site,
                           site_to=target, reason=why,
                           drift_hot=round(st.drift_hot, 4),
                           queue_s=round(st.queue_s, 6))
        return dec

    # -- reporting ----------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        mig = [e for e in self.events if e["event"] == "migrate"]
        sca = [e for e in self.events if e["event"] == "scale"]
        return {
            "ticks": self.tick,
            "migrations": len(mig),
            "scale_events": len(sca),
            "proactive_scale_events": len(
                [e for e in sca if e["trigger"] == "proactive-up"]),
            "forecaster_fits": (self.forecaster.fits
                                if self.forecaster is not None else 0),
            "events": self.events,
        }
