"""The hybrid learner decomposed into discrete, individually-invokable
pipeline stages (paper Sec. 4.4), for one stream:

  batch_inference   (batch_params, x)            -> pred
  speed_inference   (speed_params, x)            -> pred [+ fallback flag]
  weight_solve      (prev_preds, prev_y)         -> w_speed, w_batch
  hybrid_combine    (pred_speed, pred_batch, w*) -> pred
  speed_training    (data, speed_params, batch_params, key)
                                                 -> params, eval_preds, eval_y
  model_sync        (params, eval_preds, eval_y) -> speed model state update
  data_sync         (records_nbytes,)            -> archive handoff

Each stage's ``compute(**inputs) -> dict`` is wrapped by ``__call__`` with a
wall-clock measurement.  The signature check of ``model_sync`` comes with the
health slice.

The stream dimension: every stage's state contract is per stream.  A fleet
lifts the same stage objects over a ``StreamId``-keyed axis: ``FleetState``
holds each stream's serving state, ``FleetStage`` maps a single-stream stage
over ``{stream_id: kwargs}``, ``FleetInference`` and ``FleetSpeedTraining``
replace the per-stream calls with one stacked ``FleetForecaster`` predict or
fit for the whole fleet, ``ServingStage`` answers a request tick the same
way (the request plane that drives it comes with its own slice), and
``BatchRefresh`` retrains batch models from archived drifted windows in one
fleet fit.  The fleet executors drive ``FleetStages``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.weighting import (
    combine,
    dwa_closed_form,
    dwa_scipy,
    static_weights,
)
from repro_torch.serving.quantize import (
    _leaf_nbytes,
    dequantize_tree,
    tree_checksum,
    tree_leaves,
)
from repro_torch.training.optimizer import tree_map
from repro_torch.stacked import materialize_params

Params = Any


def _tensor_leaves(tree: Any) -> Iterator[torch.Tensor]:
    """The tensors of a stage's outputs, a ``QTensor``'s ``q`` and
    ``scale`` among them."""
    return (x for x in tree_leaves(tree) if isinstance(x, torch.Tensor))


@dataclass
class StageOutput:
    """What one stage invocation produced, plus its measured wall-clock."""

    values: Dict[str, Any]
    wall_s: float

    def __getitem__(self, key: str) -> Any:
        return self.values[key]


class Stage:
    """Base: times ``compute`` with a perf counter.  CUDA work is
    asynchronous, so the wrapper synchronizes every device that holds an
    output tensor before stopping the clock; otherwise a stage would be
    credited with less than the work it started."""

    name: str = "stage"

    def compute(self, **inputs: Any) -> Dict[str, Any]:
        raise NotImplementedError

    def __call__(self, **inputs: Any) -> StageOutput:
        t0 = time.perf_counter()
        values = self.compute(**inputs)
        for dev in {t.device for t in _tensor_leaves(values) if t.is_cuda}:
            torch.cuda.synchronize(dev)
        return StageOutput(values=values, wall_s=time.perf_counter() - t0)


class BatchInference(Stage):
    """M^b prediction on a window's supervised inputs."""

    name = "batch_inference"

    def __init__(self, forecaster):
        self.forecaster = forecaster

    def compute(self, *, batch_params: Params, x: np.ndarray) -> Dict[str, Any]:
        return {"pred": self.forecaster.predict(batch_params, x)}


class SpeedInference(Stage):
    """M^s_{t-1} prediction.  When no speed model has been synced yet, the
    stage degrades to serving the batch model and flags it."""

    name = "speed_inference"

    def __init__(self, forecaster):
        self.forecaster = forecaster

    def compute(self, *, speed_params: Optional[Params], x: np.ndarray,
                fallback_params: Optional[Params] = None) -> Dict[str, Any]:
        fallback = speed_params is None
        params = fallback_params if fallback else speed_params
        if params is None:
            raise ValueError("speed_inference: no speed model and no fallback")
        return {"pred": self.forecaster.predict(params, x),
                "fallback": fallback}


class WeightSolve(Stage):
    """Algorithm 1 (dynamic) or static/degenerate weights.

    mode: "dynamic", ("static", w_speed), "speed", "batch".
    """

    name = "weight_solve"

    def __init__(self, mode="dynamic", dwa_solver: str = "closed_form"):
        self.mode = mode
        self.dwa_solver = dwa_solver

    def compute(self, *, prev_preds: Optional[Tuple[np.ndarray, np.ndarray]],
                prev_y: Optional[np.ndarray]) -> Dict[str, Any]:
        if isinstance(self.mode, tuple) and self.mode[0] == "static":
            ws, wb = static_weights(self.mode[1])
            return {"w_speed": ws, "w_batch": wb}
        if self.mode == "dynamic":
            if prev_preds is None:
                return {"w_speed": 0.5, "w_batch": 0.5}
            if self.dwa_solver == "scipy":
                w = dwa_scipy([prev_preds[0], prev_preds[1]], prev_y)
                ws, wb = float(w[0]), float(w[1])
            else:
                ws, wb = dwa_closed_form(prev_preds[0], prev_preds[1], prev_y)
            return {"w_speed": ws, "w_batch": wb}
        if self.mode == "speed":
            return {"w_speed": 1.0, "w_batch": 0.0}
        if self.mode == "batch":
            return {"w_speed": 0.0, "w_batch": 1.0}
        raise ValueError(f"unknown mode {self.mode!r}")

    @property
    def is_dynamic(self) -> bool:
        return self.mode == "dynamic"


class HybridCombine(Stage):
    """Pred_hybrid = W_s * Pred_speed + W_b * Pred_batch."""

    name = "hybrid_combine"

    def compute(self, *, pred_speed: np.ndarray, pred_batch: np.ndarray,
                w_speed: float, w_batch: float) -> Dict[str, Any]:
        return {"pred": combine([pred_speed, pred_batch], [w_speed, w_batch])}


class SpeedTraining(Stage):
    """Train M^s_t on window t's records and stash the Algorithm-1 inputs:
    predictions of (M^s_t, M^b) on window t, consumed when weighting window
    t+1.  ``train_wall_s`` is the forecaster-reported fit time (excludes the
    eval predictions); ``CompiledForecaster`` stops that clock after
    ``torch.cuda.synchronize()``, so it holds the fit's device work."""

    name = "speed_training"

    def __init__(self, forecaster):
        self.forecaster = forecaster

    def compute(self, *, data: Dict[str, np.ndarray],
                speed_params: Optional[Params], batch_params: Params,
                key) -> Dict[str, Any]:
        fc = self.forecaster
        if speed_params is not None:
            # the serving model may be the int8-synced tree (QTensor leaves);
            # training runs in float, so dequantize at the stage boundary
            # (no-op on a float tree)
            speed_params = dequantize_tree(speed_params)
        params, train_wall_s = fc.train(data, speed_params, key)
        x, y = data["x"], data["y"]
        eval_preds = eval_y = None
        if len(x) > 0:
            eval_preds = (fc.predict(params, x),
                          fc.predict(batch_params, x))
            eval_y = y
        return {"params": params, "train_wall_s": train_wall_s,
                "eval_preds": eval_preds, "eval_y": eval_y}


class ModelSync(Stage):
    """Install a freshly-published speed model (plus its Algorithm-1 eval
    predictions) as the serving state.  Pure pass-through compute; the cost
    of this module is the model transfer, which the executor accounts as
    communication.

    When the publish carries a ``checksum`` (``serving.quantize.
    tree_checksum``, stamped by the training site), the stage verifies it
    before installing anything: a mismatch returns ``ok=False`` with no
    state, and counts in ``corrupt_rejected``; a match counts in
    ``verified``.  A corrupt model is never served.  The HMAC signature
    check comes with the health slice: until then, passing ``signature`` or
    ``sig_key`` raises."""

    name = "model_sync"

    _REJECT = {"ok": False, "speed_params": None,
               "prev_preds": None, "prev_y": None}

    def __init__(self):
        self.verified = 0
        self.corrupt_rejected = 0

    def compute(self, *, params: Params, eval_preds, eval_y,
                checksum: Optional[int] = None,
                signature: Optional[str] = None,
                sig_key: Optional[bytes] = None) -> Dict[str, Any]:
        if signature is not None or sig_key is not None:
            raise NotImplementedError(
                "model_sync: signature verification comes with the health "
                "slice of the port")
        if checksum is not None:
            if tree_checksum(params) != checksum:
                self.corrupt_rejected += 1
                return dict(self._REJECT)
            self.verified += 1
        return {"ok": True, "speed_params": params, "prev_preds": eval_preds,
                "prev_y": eval_y}


class DataSync(Stage):
    """Raw-data archiving handoff (S3 analog); compute-free, its cost is the
    window transfer to the archiving site."""

    name = "data_sync"

    def compute(self, *, nbytes: float = 0.0) -> Dict[str, Any]:
        return {"nbytes": nbytes}


@dataclass
class PipelineStages:
    """The full stage set one executor drives.  Build with :meth:`build` so
    every executor runs literally the same stage objects."""

    batch_inference: BatchInference
    speed_inference: SpeedInference
    weight_solve: WeightSolve
    hybrid_combine: HybridCombine
    speed_training: SpeedTraining
    model_sync: ModelSync
    data_sync: DataSync

    @classmethod
    def build(cls, forecaster, mode="dynamic",
              dwa_solver: str = "closed_form") -> "PipelineStages":
        return cls(
            batch_inference=BatchInference(forecaster),
            speed_inference=SpeedInference(forecaster),
            weight_solve=WeightSolve(mode, dwa_solver),
            hybrid_combine=HybridCombine(),
            speed_training=SpeedTraining(forecaster),
            model_sync=ModelSync(),
            data_sync=DataSync(),
        )

    @property
    def mode(self):
        return self.weight_solve.mode


# ---------------------------------------------------------------------------
# The fleet dimension: StreamId-keyed state + fleet-lifted stages
# ---------------------------------------------------------------------------

StreamId = str


@dataclass
class StreamState:
    """One stream's serving-side state: the installed speed model plus the
    Algorithm-1 inputs its last retrain produced.  This is the per-stream
    unit every stage's state contract is expressed in — the pre-fleet
    executors carried exactly one of these."""

    speed_params: Optional[Params] = None
    prev_preds: Optional[Tuple[np.ndarray, np.ndarray]] = None
    prev_y: Optional[np.ndarray] = None
    window: int = -1


@dataclass
class FleetState:
    """``StreamId``-keyed serving state for a fleet of streams."""

    streams: Dict[StreamId, StreamState] = field(default_factory=dict)

    def state(self, sid: StreamId) -> StreamState:
        """The stream's state, created empty on first touch."""
        st = self.streams.get(sid)
        if st is None:
            st = self.streams[sid] = StreamState()
        return st

    def ids(self) -> List[StreamId]:
        return list(self.streams)

    def __len__(self) -> int:
        return len(self.streams)

    def handoff(self, sid: StreamId) -> float:
        """Prepare one stream's device-resident state for migration to
        another site and return its transfer size in bytes.

        A stream fresh out of fleet training holds a lazy params handle
        (``FleetParamView``) into the stacked fit output, a view, not bytes
        the stream owns.  Migration is the boundary where that view must
        leave its stream-count bucket, so the handoff materializes it: here a copy of its
        slice of the stacked tree on the device, which the stream owns."""
        st = self.state(sid)
        if st.speed_params is not None:
            st.speed_params = tree_map(torch.clone,
                                       materialize_params(st.speed_params))
        return float(sum(_leaf_nbytes(leaf)
                         for part in (st.speed_params, st.prev_preds,
                                      st.prev_y)
                         for leaf in tree_leaves(part)))


def resolve_fleet_params(batch_params: Any, ids: List[StreamId]
                         ) -> Dict[StreamId, Params]:
    """Normalize a batch-model argument to per-stream form: a mapping whose
    keys cover every stream id is already per-stream; anything else (a
    params tree — itself a dict, but keyed by layer names, not stream ids)
    is one model shared by the whole fleet.  A mapping that names *some*
    stream ids but not all is almost certainly an incomplete per-stream
    mapping — reject it loudly rather than hand every stream the whole
    stream-keyed dict as its params tree."""
    if isinstance(batch_params, Mapping):
        hits = set(ids) & set(batch_params)
        if set(ids) <= set(batch_params):
            return {sid: batch_params[sid] for sid in ids}
        if hits:
            raise ValueError(
                "per-stream batch params mapping is missing streams "
                f"{sorted(set(ids) - set(batch_params))}")
    return {sid: batch_params for sid in ids}


class FleetStage(Stage):
    """Lift a single-stream stage to a fleet: ``compute`` maps the wrapped
    stage over a ``{stream_id: kwargs}`` dict and returns per-stream
    ``StageOutput``s (each individually wall-clocked by the wrapped stage's
    own ``__call__``).  The wrapped stage object is untouched and still
    directly callable, so the single-stream API is preserved verbatim."""

    def __init__(self, stage: Stage):
        self.stage = stage
        self.name = stage.name

    def compute(self, *, fleet: Dict[StreamId, Dict[str, Any]]
                ) -> Dict[str, Any]:
        return {"fleet": {sid: self.stage(**kw) for sid, kw in fleet.items()}}


class FleetInference(Stage):
    """The batched fleet eval/inference contract: the whole fleet's
    per-stream predictions in **one** stacked device dispatch
    (``FleetForecaster.predict_fleet``), mirroring the aggregated train
    dispatch — same ``{stream_id: kwargs}`` contract and per-stream
    ``StageOutput`` results as the per-stream :class:`FleetStage` lift it
    replaces, so executors drive it unchanged.

    Each stream's ``StageOutput`` carries the shared aggregate wall (the
    same convention the fleet training dispatch uses for
    ``t_speed_train``).  A one-stream fleet delegates to the wrapped
    single-stream stage, keeping that path byte-identical to the pre-fleet
    code.  ``kind="speed"`` resolves the per-stream batch-model fallback
    (a stream with no synced speed model serves ``fallback_params`` and is
    flagged) *before* the aggregated dispatch, so an all-fallback fleet
    predicts bit-identically to the batched batch-inference stage."""

    def __init__(self, fleet_forecaster, stage: Stage, kind: str):
        self.forecaster = fleet_forecaster
        self.stage = stage
        self.kind = kind
        self.name = stage.name
        # windows served / stacked dispatches spent (one a window, as
        # ServingStage's one a tick)
        self.ticks = 0
        self.dispatches = 0

    def compute(self, *, fleet: Dict[StreamId, Dict[str, Any]]
                ) -> Dict[str, Any]:
        sids = list(fleet)
        self.ticks += 1
        if len(sids) <= 1:
            self.dispatches += 1
            return {"fleet": {sid: self.stage(**kw)
                              for sid, kw in fleet.items()}}
        t0 = time.perf_counter()
        params: List[Any] = []
        fallback: Dict[StreamId, bool] = {}
        for sid in sids:
            kw = fleet[sid]
            if self.kind == "speed":
                fb = kw.get("speed_params") is None
                p = kw.get("fallback_params") if fb else kw["speed_params"]
                if p is None:
                    raise ValueError(
                        "speed_inference: no speed model and no fallback")
                fallback[sid] = fb
            else:
                p = kw["batch_params"]
            params.append(p)
        d0 = getattr(self.forecaster, "predict_dispatches", 0)
        preds = self.forecaster.predict_fleet(
            params, [fleet[sid]["x"] for sid in sids])
        d1 = getattr(self.forecaster, "predict_dispatches", 0)
        self.dispatches += (d1 - d0) if d1 > d0 else 1
        wall = time.perf_counter() - t0
        out: Dict[StreamId, StageOutput] = {}
        for sid, pred in zip(sids, preds):
            values = {"pred": pred}
            if self.kind == "speed":
                values["fallback"] = fallback[sid]
            out[sid] = StageOutput(values=values, wall_s=wall)
        return {"fleet": out}


class FleetSpeedTraining(Stage):
    """Whole-fleet speed training in one stacked device dispatch
    (``FleetForecaster.train_fleet``), plus the per-stream Algorithm-1 eval
    predictions the single-stream ``SpeedTraining`` stashes — themselves
    aggregated into one ``predict_fleet`` dispatch per model (the fresh
    speed models read straight from the device-resident stacked fit
    output; the batch models stack per stream), instead of 2N per-stream
    predicts.  The per-stream params handles stay lazy
    (``FleetParamView``): a host copy is made only at a publish
    boundary.  Drift gating happens *above* this stage: the caller passes
    only the streams whose gate said retrain, and the stream-count buckets
    absorb the varying subset sizes."""

    name = "speed_training"

    def __init__(self, fleet_forecaster):
        self.forecaster = fleet_forecaster

    def compute(self, *, fleet_data: Dict[StreamId, Dict[str, np.ndarray]],
                batch_params: Any, keys: Dict[StreamId, Any]
                ) -> Dict[str, Any]:
        fc = self.forecaster
        sids = list(fleet_data)
        bp = resolve_fleet_params(batch_params, sids)
        params_list, train_wall_s = fc.train_fleet(
            [fleet_data[s] for s in sids], [keys[s] for s in sids])
        ev = [i for i, s in enumerate(sids) if len(fleet_data[s]["x"]) > 0]
        preds_speed: Dict[int, np.ndarray] = {}
        preds_batch: Dict[int, np.ndarray] = {}
        if ev:
            xs = [fleet_data[sids[i]]["x"] for i in ev]
            preds_speed = dict(zip(ev, fc.predict_fleet(
                [params_list[i] for i in ev], xs)))
            preds_batch = dict(zip(ev, fc.predict_fleet(
                [bp[sids[i]] for i in ev], xs)))
        fleet = {}
        for i, (sid, params) in enumerate(zip(sids, params_list)):
            eval_preds = eval_y = None
            if i in preds_speed:
                eval_preds = (preds_speed[i], preds_batch[i])
                eval_y = fleet_data[sid]["y"]
            fleet[sid] = {"params": params, "eval_preds": eval_preds,
                          "eval_y": eval_y}
        return {"fleet": fleet, "train_wall_s": train_wall_s}


class ServingStage(Stage):
    """The request plane's batched answer dispatch: every serving tick, the
    active queries of *all* streams predict in **one** stacked
    ``FleetForecaster.predict_fleet`` call over the device-resident serving
    params (streams with no active query contribute a zero-row batch).  Shared-wall convention: the one
    measured ``__call__`` wall is the whole tick's cost, charged once by
    the executor under the serving site's worker occupancy.

    ``ticks`` / ``dispatches`` count serving ticks and the stacked
    dispatches they cost — the bench gate asserts dispatches/tick == 1.
    A one-stream fleet delegates inside ``predict_fleet`` to the single
    path; it is still one dispatch, counted as such here.
    """

    name = "serving"

    def __init__(self, fleet_forecaster):
        self.forecaster = fleet_forecaster
        self.ticks = 0
        self.dispatches = 0

    def compute(self, *, params_seq: List[Any], xs: List[np.ndarray]
                ) -> Dict[str, Any]:
        fc = self.forecaster
        d0 = getattr(fc, "predict_dispatches", 0)
        preds = fc.predict_fleet(params_seq, xs)
        d1 = getattr(fc, "predict_dispatches", 0)
        self.dispatches += (d1 - d0) if len(xs) > 1 else 1
        self.ticks += 1
        return {"preds": preds}


class BatchRefresh(Stage):
    """The queued cloud-side heavy-retraining path: gated *batch-model*
    refresh from archived drifted windows, riding the same stacked fleet
    fit as speed training.

    Every window whose drift gate fired is archived per stream (a bounded
    deque of supervised windows — drifted data is exactly what the serving
    batch model has gone stale on).  Every ``every`` windows, streams whose
    archive holds at least ``min_windows`` windows refresh together: each
    stream's archive concatenates into one training set and the whole
    cohort retrains in **one** ``FleetForecaster.train_fleet`` dispatch —
    stream-count-bucketed, exactly the hot path — instead of S sequential
    cloud fits.  The refreshed params
    replace that stream's batch model for every subsequent batch-inference
    dispatch and Algorithm-1 weight solve; its archive is consumed.

    Archives are capped at ``max_windows`` (most recent kept), which also
    bounds the refresh's example-count bucket to a handful of shapes."""

    name = "batch_refresh"

    def __init__(self, fleet_forecaster, *, every: int = 4,
                 min_windows: int = 2, max_windows: int = 8):
        if every <= 0:
            raise ValueError(f"refresh period must be positive, got {every}")
        self.forecaster = fleet_forecaster
        self.every = every
        self.min_windows = max(min_windows, 1)
        self.max_windows = max(max_windows, self.min_windows)
        self._archive: Dict[StreamId, List[Dict[str, np.ndarray]]] = {}
        self.dispatches = 0
        self.rounds = 0
        self.refreshed: Dict[StreamId, int] = {}
        self.train_wall_s = 0.0

    def reset(self) -> None:
        """Per-run state: clear the archives and the run counters."""
        self._archive.clear()
        self.refreshed = {}
        self.dispatches = 0
        self.rounds = 0
        self.train_wall_s = 0.0

    def archive(self, sid: StreamId, data: Dict[str, np.ndarray]) -> None:
        """Queue one drifted window of stream ``sid`` for its next refresh."""
        if len(next(iter(data.values()))) == 0:
            return
        q = self._archive.setdefault(sid, [])
        q.append({k: np.asarray(v) for k, v in data.items()})
        if len(q) > self.max_windows:
            del q[: len(q) - self.max_windows]

    def due(self, t: int) -> bool:
        return (t + 1) % self.every == 0

    def ready(self) -> List[StreamId]:
        return [s for s, q in self._archive.items()
                if len(q) >= self.min_windows]

    def compute(self, *, keys: Dict[StreamId, Any]) -> Dict[str, Any]:
        fc = self.forecaster
        sids = [s for s in self.ready() if s in keys]
        if not sids:
            return {"fleet": {}, "train_wall_s": 0.0}
        datas = []
        for s in sids:
            q = self._archive[s]
            datas.append({k: np.concatenate([w[k] for w in q]) for k in q[0]})
        d0 = fc.train_dispatches
        params_list, wall = fc.train_fleet(datas, [keys[s] for s in sids])
        self.dispatches += fc.train_dispatches - d0
        self.rounds += 1
        self.train_wall_s += wall
        for s in sids:
            self._archive[s] = []
            self.refreshed[s] = self.refreshed.get(s, 0) + 1
        return {"fleet": dict(zip(sids, params_list)), "train_wall_s": wall}


@dataclass
class FleetStages:
    """The fleet-level stage set: the *same* single-stream stage objects
    (``single`` is a fully functional ``PipelineStages``) lifted per-stream
    by ``FleetStage``, plus the one-dispatch whole-fleet stages — speed
    training (``FleetSpeedTraining``) and batch/speed inference
    (``FleetInference``), each one aggregated device dispatch per window
    instead of N."""

    single: PipelineStages
    batch_inference: FleetInference
    speed_inference: FleetInference
    weight_solve: FleetStage
    hybrid_combine: FleetStage
    speed_training: FleetSpeedTraining
    model_sync: FleetStage
    data_sync: FleetStage
    serving: Optional[ServingStage] = None

    @classmethod
    def build(cls, fleet_forecaster, mode="dynamic",
              dwa_solver: str = "closed_form") -> "FleetStages":
        """``fleet_forecaster`` is a ``FleetForecaster`` (it satisfies the
        single-stream ``Forecaster`` protocol by delegation, so the wrapped
        ``PipelineStages`` serve per-stream inference unchanged)."""
        single = PipelineStages.build(fleet_forecaster, mode, dwa_solver)
        return cls(
            single=single,
            batch_inference=FleetInference(fleet_forecaster,
                                           single.batch_inference, "batch"),
            speed_inference=FleetInference(fleet_forecaster,
                                           single.speed_inference, "speed"),
            weight_solve=FleetStage(single.weight_solve),
            hybrid_combine=FleetStage(single.hybrid_combine),
            speed_training=FleetSpeedTraining(fleet_forecaster),
            model_sync=FleetStage(single.model_sync),
            data_sync=FleetStage(single.data_sync),
            serving=ServingStage(fleet_forecaster),
        )

    @property
    def mode(self):
        return self.single.mode
