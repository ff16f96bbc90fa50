"""Executors: schedule the hybrid learner's pipeline stages
(``repro_torch.core.stages``) under a deployment placement.

``InProcessExecutor`` replays the paper's synchronous per-window loop with
the reference's window bookkeeping and record timing conventions.

``BusExecutor`` runs the *same stage objects* as ``TopicBus`` subscribers
placed per a ``Deployment`` map, as the reference's does: windows are
injected onto the stream topic, each stage's real wall-clock is measured
(synced on the card, ``Stage.__call__``), rescaled by its site's
``compute_scale`` and accounted in the ``LatencyLedger``.  Stage completions
advance virtual time, so the paper's M^s_{t-1} semantics (stale-model
inference while speed training is in flight) emerge from event ordering.
Each site runs a worker pool (``Site.workers``), so a co-located training
attempt delays the inference chain (the paper's edge-centric contention);
capacity is a model: speed training on a site that cannot hold
``CostModel.train_memory_bytes`` records a failure, charges the modeled
thrash (``CostModel.oom_thrash_s``) and never publishes, so the edge-centric
speed layer serves the batch model (paper Sec. 6.2).  With
``quantized_sync=True`` the training site publishes the int8 tree and the
edge serves it through the int8 kernel.

The fleet executors lift both to N streams under one deployment:
``InProcessFleetExecutor`` is the synchronous loop over a ``FleetStages``
set, and ``FleetBusExecutor`` multiplexes the bus topics per stream
(``stream/window/t03``, one wildcard subscription per module, or one exact
subscription per stream under the placement plane).  Each window
costs one stacked fleet fit (each step one launch of each training kernel
for the whole fleet) and one stacked predict per inference stage; the bus
executor aggregates every stream's window-``t`` payload at a stage before
it fires, then fans the per-stream results back onto their own topics.
Both consult an optional ``DriftGate`` so stationary streams skip their
retrain and keep serving their prior model.  Stream ``i``'s training keys
are the chain a single-stream run seeded with its root gets
(``fleet_key_chains``).  ``FleetBusExecutor`` also carries the request plane
(user queries answered by serving ticks, one stacked predict a tick), the
elastic placement plane (``runtime.placement``), the chaos plane
(``runtime.faults``) and the health plane (``runtime.health``).
"""
from __future__ import annotations

import contextlib
import gc
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

import time

import numpy as np

from repro_torch.core.drift import DriftGate
from repro_torch.core.hybrid import HybridRunResult, WindowRecord
from repro_torch.core.stages import (
    BatchRefresh,
    FleetStages,
    FleetState,
    PipelineStages,
    StreamId,
    resolve_fleet_params,
)
from repro_torch.core.weighting import rmse
from repro_torch.core.windows import WindowedStream
from repro_torch.runtime.bus import (
    CapacityError,
    EventKernel,
    Message,
    TopicBus,
    Topology,
)
from repro_torch.runtime.deployment import STREAM_MODULES, Deployment
from repro_torch.runtime.health import sign_tree
from repro_torch.runtime.latency import CostModel, LatencyLedger
from repro_torch.runtime.modules import (
    T_BATCH,
    T_CTRL,
    T_HEALTH_CHECK,
    T_HEALTH_HB,
    T_HYBRID,
    T_MODEL,
    T_REQUEST,
    T_RESPONSE,
    T_RESYNC,
    T_SPEED,
    T_STREAM,
    stream_topic,
)
from repro_torch.runtime.placement import (
    PlacementController,
    SiteSignal,
    StreamSignal,
)
from repro_torch.serving.quantize import (
    quantize_fleet,
    quantize_tree,
    tree_checksum,
    tree_nbytes,
)
from repro_torch.serving.query_plane import (
    QueryPlane,
    latency_stats,
    open_loop_trace,
)
from repro_torch.stacked import materialize_params
from repro_torch.streams.injection import BusInjector

Params = Any

# the bus serves from window 1 on: window 0 only trains the first speed model
_FIRST_SERVED_WINDOW = 1


def window_seeds(seed: int, n: int) -> List[int]:
    """The per-window training keys: ``n`` integers drawn from
    ``numpy.random.SeedSequence(seed)``, so every executor derives the same
    keys for the same seed."""
    return [int(k) for k in np.random.SeedSequence(seed).generate_state(n)]


def warmup_seed(seed: int) -> int:
    """The key of ``BusExecutor``'s warm-up fit: the first integer of the
    first child ``SeedSequence(seed).spawn`` gives, an independent stream, so
    it is none of the window keys (the reference folds 0 into its key)."""
    return int(np.random.SeedSequence(seed).spawn(1)[0].generate_state(1)[0])


def _nbytes(tree: Any) -> float:
    """Real byte size of a tree of tensors or arrays (measured model and
    result sizes), read from shapes and types without a copy off the
    device."""
    return float(tree_nbytes(tree))


class InProcessExecutor:
    """The paper's synchronous loop over the extracted stages: same window
    bookkeeping and ``WindowRecord`` timing conventions as the reference
    (``t_weight_solve`` counts only the dynamic solve)."""

    def __init__(self, stages: PipelineStages, start_window: int = 1):
        self.stages = stages
        self.start_window = start_window

    def run(self, stream: WindowedStream, batch_params: Params, seed: int,
            n_windows: Optional[int] = None) -> HybridRunResult:
        st = self.stages
        n = len(stream) if n_windows is None else min(n_windows, len(stream))
        keys = window_seeds(seed, n)
        records: List[WindowRecord] = []
        speed_params: Optional[Params] = None
        prev_preds = prev_y = None

        for t in range(n):
            data = stream.supervised(t)
            x, y = data["x"], data["y"]
            if t >= self.start_window and speed_params is not None and len(x) > 0:
                b = st.batch_inference(batch_params=batch_params, x=x)
                s = st.speed_inference(speed_params=speed_params, x=x)
                w = st.weight_solve(prev_preds=prev_preds, prev_y=prev_y)
                t_w = (w.wall_s if st.weight_solve.is_dynamic
                       and prev_preds is not None else 0.0)
                h = st.hybrid_combine(
                    pred_speed=s["pred"], pred_batch=b["pred"],
                    w_speed=w["w_speed"], w_batch=w["w_batch"])
                records.append(WindowRecord(
                    window=t,
                    rmse_batch=rmse(y, b["pred"]),
                    rmse_speed=rmse(y, s["pred"]),
                    rmse_hybrid=rmse(y, h["pred"]),
                    w_speed=w["w_speed"],
                    w_batch=w["w_batch"],
                    t_batch_infer=b.wall_s,
                    t_speed_infer=s.wall_s,
                    t_hybrid_infer=h.wall_s + t_w,
                    t_weight_solve=t_w,
                ))
            # training phase: speed model for the next window
            tr = st.speed_training(data=data, speed_params=speed_params,
                                   batch_params=batch_params, key=keys[t])
            if records and records[-1].window == t:
                records[-1].t_speed_train = tr["train_wall_s"]
            if tr["eval_preds"] is not None:
                prev_preds, prev_y = tr["eval_preds"], tr["eval_y"]
            speed_params = tr["params"]
        return HybridRunResult(records=records, mode=str(st.mode))


@dataclass
class BusRunResult:
    """What one ``BusExecutor`` run produced: real per-window accuracy
    records plus the measured (rescaled) latency ledger and per-window
    end-to-end latency (window injected -> hybrid result delivered back to
    the injection site)."""

    records: List[WindowRecord]
    ledger: LatencyLedger
    failures: List[str]
    n_windows: int
    e2e_s: Dict[int, float]
    message_log: List[Message]
    mode: str

    def table3(self) -> Dict[str, Dict[str, float]]:
        return self.ledger.table()

    def mean_e2e_s(self) -> float:
        if not self.e2e_s:
            return float("nan")
        return float(np.mean(list(self.e2e_s.values())))

    def to_hybrid_result(self) -> HybridRunResult:
        return HybridRunResult(records=self.records, mode=self.mode)


@dataclass
class _ModelState:
    """The serving-side speed model installed by model_sync."""

    params: Optional[Params] = None
    prev_preds: Optional[tuple] = None
    prev_y: Optional[np.ndarray] = None
    window: int = -1


@contextlib.contextmanager
def frozen_heap():
    """Run a bus executor's measured event loop on a frozen heap: every
    object alive when it starts moves to the collector's permanent
    generation (``gc.freeze``) until it ends, so a collection during the
    loop walks only the objects the run makes.  Otherwise the one
    generation-2 collection a 64-stream run triggers walks the whole
    process's heap (0.2-0.4 s on an H100 machine's host, longer in a
    process that holds more) and, when it lands inside a measured stage,
    becomes part of that stage's wall."""
    gc.freeze()
    try:
        yield
    finally:
        gc.unfreeze()


class _BusRuntime:
    """Shared machinery of the bus-driven executors: the event kernel +
    topic bus + latency ledger lifecycle, the site scheduler that rescales
    measured walls to a site's hardware class and queues work behind
    earlier work on the site's worker pool, the training capacity model,
    and the stage-agnostic handlers.  Subclasses provide ``dep``, ``topo``,
    ``cost``, ``strict`` and ``_single_stages``.  An optional
    ``fault_plane`` and ``stage_costs`` are read with ``getattr``: only the
    fleet executor has them."""

    dep: Deployment
    topo: Topology
    cost: CostModel
    strict: bool

    def _init_runtime(self) -> None:
        self.kernel = EventKernel()
        self.bus = TopicBus(self.kernel, self.topo,
                            fault_plane=getattr(self, "fault_plane", None))
        self.ledger = LatencyLedger()
        self.failures: List[str] = []
        self._free: Dict[str, List[float]] = {}

    @property
    def _single_stages(self) -> PipelineStages:
        raise NotImplementedError

    def _site(self, module: str):
        return self.topo.sites[self.dep.site_of(module)]

    def _train_fits_site(self, comm_s: float) -> bool:
        """The capacity model: True when the training site can hold the
        job.  Otherwise record the paper's OOM failure, charge the modeled
        thrash of the attempt (``CostModel.oom_thrash_s``) and never let a
        model publish."""
        site = self._site("speed_training")
        if self.cost.train_memory_bytes <= site.memory_bytes:
            return True
        self.failures.append(
            f"speed_training OOM on {site.name}: needs "
            f"{self.cost.train_memory_bytes/1e9:.1f} GB > "
            f"{site.memory_bytes/1e9:.1f} GB")
        if self.strict:
            raise CapacityError(self.failures[-1])
        self._schedule("speed_training", self.cost.oom_thrash_s, comm_s)
        return False

    def _on_data_sync(self, msg: Message) -> None:
        out = self._single_stages.data_sync(nbytes=msg.nbytes)
        link = self.topo.link(self.dep.site_of("data_sync"),
                              self.dep.site_of("archiving"))
        self._schedule("data_sync", out.wall_s,
                       link.transfer_time(out["nbytes"]))

    def _on_archive(self, msg: Message) -> None:
        self.ledger.add("archiving", comp_s=0.0,
                        comm_s=msg.deliver_time - msg.publish_time)

    def _pool(self, site) -> List[float]:
        """The site's busy-until worker pool, lazily resized when
        ``site.workers`` changed: grown workers start idle now; a shrink
        drops idle entries only (a busy worker finishes what it
        admitted)."""
        now = self.kernel.now
        pool = self._free.setdefault(site.name, [now] * max(site.workers, 1))
        want = max(site.workers, 1)
        if len(pool) < want:
            pool.extend([now] * (want - len(pool)))
        elif len(pool) > want:
            for i in range(len(pool) - 1, -1, -1):
                if len(pool) <= want:
                    break
                if pool[i] <= now:
                    del pool[i]
        return pool

    def _backlog_s(self, site_name: str) -> float:
        """Seconds of admitted-but-unfinished work queued on the site."""
        now = self.kernel.now
        return sum(max(0.0, p - now) for p in self._free.get(site_name, []))

    def _schedule(self, module: str, wall_s: float, comm_s: float,
                  done: Optional[Callable[[], None]] = None,
                  site_name: Optional[str] = None) -> None:
        """Account a stage that took ``wall_s`` real seconds: rescale to the
        site's hardware class, queue it behind earlier work on the site's
        worker pool, and fire ``done`` at its virtual completion.

        ``site_name`` overrides the deployment's placement for the module.
        An optional ``stage_costs`` map (module -> wall seconds) replaces
        the measured wall with a fixed virtual cost.  If the module's site
        is down (``fault_plane.site_down``) when the stage would complete,
        the in-flight work is lost: no ledger entry, no completion.  The
        site's queue depth is sampled at entry and again at completion."""
        site = (self.topo.sites[site_name] if site_name is not None
                else self._site(module))
        sc = getattr(self, "stage_costs", None)
        if sc is not None and module in sc:
            wall_s = sc[module]
        scaled = wall_s / max(site.compute_scale, 1e-9)
        pool = self._pool(site)
        self.ledger.sample_depth(site.name, self.kernel.now,
                                 self._backlog_s(site.name))
        i = min(range(len(pool)), key=pool.__getitem__)
        start = max(self.kernel.now, pool[i])
        queue_s = start - self.kernel.now
        pool[i] = start + scaled

        def finish():
            fp = getattr(self, "fault_plane", None)
            if fp is not None and fp.site_down(site.name, self.kernel.now):
                fp.note("lost_inflight_work", self.kernel.now,
                        f"{module}@{site.name}")
                return
            self.ledger.add(module, comp_s=scaled, comm_s=comm_s,
                            queue_s=queue_s)
            self.ledger.sample_depth(site.name, self.kernel.now,
                                     self._backlog_s(site.name))
            if done is not None:
                done()

        self.kernel.at(start + scaled, finish)


class BusExecutor(_BusRuntime):
    """Drive the stages as topic-bus subscribers under a placement map.

    The ``CostModel`` is consulted only for what cannot be measured: the
    Kafka ingest throttle (``ingest_s``, charged as communication on stream
    consumers) and the training job's memory footprint (the capacity
    model).  All compute is measured; all transfer sizes are the real
    tensor and array byte counts.  The executor runs where its stages'
    forecaster runs: the current CUDA device unless that was built with
    ``device="cpu"``.

    ``quantized_sync=True`` turns on the int8 model sync (the paper's
    TFLite-on-Pi analog): the training site quantizes the fresh speed model
    (``serving.quantize.quantize_tree``, leaves of at least
    ``quant_min_size`` elements) before publishing it, the model topic
    carries the int8 byte count (9,644 B against 31,124 for the paper's
    LSTM), and the edge serves the ``QTensor`` tree through the int8
    kernel.  Every publish is stamped with ``tree_checksum``, which
    ``ModelSync`` verifies.
    """

    def __init__(
        self,
        stages: PipelineStages,
        deployment: Deployment,
        topo: Topology,
        cost: Optional[CostModel] = None,
        *,
        window_period_s: float = 30.0,
        strict_capacity: bool = False,
        quantized_sync: bool = False,
        quant_min_size: int = 64,
    ):
        self.stages = stages
        self.dep = deployment
        self.topo = topo
        self.cost = cost or CostModel()
        self.period = window_period_s
        self.strict = strict_capacity
        self.quantized_sync = quantized_sync
        self.quant_min_size = quant_min_size

    @property
    def _single_stages(self) -> PipelineStages:
        return self.stages

    # -- per-run state -------------------------------------------------------

    def _reset(self) -> None:
        self._init_runtime()
        self._model = _ModelState()
        self._records: Dict[int, WindowRecord] = {}
        self._train_walls: Dict[int, float] = {}
        self._pending: Dict[int, Dict[str, Message]] = {}
        self._inject_t: Dict[int, float] = {}
        self.e2e_s: Dict[int, float] = {}
        self._wire()

    def _wire(self) -> None:
        dep, bus = self.dep, self.bus
        bus.subscribe(T_STREAM, dep.site_of("batch_inference"), self._on_batch)
        bus.subscribe(T_STREAM, dep.site_of("speed_inference"), self._on_speed)
        bus.subscribe(T_STREAM, dep.site_of("speed_training"), self._on_train)
        bus.subscribe(T_STREAM, dep.site_of("data_sync"), self._on_data_sync)
        bus.subscribe(T_BATCH, dep.site_of("hybrid_inference"), self._on_part)
        bus.subscribe(T_SPEED, dep.site_of("hybrid_inference"), self._on_part)
        bus.subscribe(T_HYBRID, dep.site_of("archiving"), self._on_archive)
        bus.subscribe(T_HYBRID, dep.site_of("data_injection"), self._on_user)
        bus.subscribe(T_MODEL, dep.site_of("model_sync"), self._on_model_sync)

    # -- handlers ------------------------------------------------------------

    def _on_batch(self, msg: Message) -> None:
        w = msg.payload["window"]
        if w < _FIRST_SERVED_WINDOW:
            return
        comm = msg.deliver_time - msg.publish_time + self.cost.ingest_s
        out = self.stages.batch_inference(
            batch_params=self._batch_params, x=msg.payload["x"])
        self._schedule(
            "batch_inference", out.wall_s, comm,
            lambda: self.bus.publish(
                T_BATCH,
                {"window": w, "kind": "batch", "pred": out["pred"],
                 "wall_s": out.wall_s, "fallback": False},
                _nbytes(out["pred"]), self.dep.site_of("batch_inference")))

    def _on_speed(self, msg: Message) -> None:
        w = msg.payload["window"]
        if w < _FIRST_SERVED_WINDOW:
            return
        comm = msg.deliver_time - msg.publish_time + self.cost.ingest_s
        out = self.stages.speed_inference(
            speed_params=self._model.params, x=msg.payload["x"],
            fallback_params=self._batch_params)
        self._schedule(
            "speed_inference", out.wall_s, comm,
            lambda: self.bus.publish(
                T_SPEED,
                {"window": w, "kind": "speed", "pred": out["pred"],
                 "wall_s": out.wall_s, "fallback": out["fallback"]},
                _nbytes(out["pred"]), self.dep.site_of("speed_inference")))

    def _on_part(self, msg: Message) -> None:
        w = msg.payload["window"]
        parts = self._pending.setdefault(w, {})
        parts[msg.payload["kind"]] = msg
        if len(parts) < 2:
            return
        st = self.stages
        bmsg, smsg = parts["batch"], parts["speed"]
        comm = max(m.deliver_time - m.publish_time for m in parts.values())
        wsol = st.weight_solve(prev_preds=self._model.prev_preds,
                               prev_y=self._model.prev_y)
        t_w = (wsol.wall_s if st.weight_solve.is_dynamic
               and self._model.prev_preds is not None else 0.0)
        hc = st.hybrid_combine(
            pred_speed=smsg.payload["pred"], pred_batch=bmsg.payload["pred"],
            w_speed=wsol["w_speed"], w_batch=wsol["w_batch"])
        y = self._ys[w]
        rec = WindowRecord(
            window=w,
            rmse_batch=rmse(y, bmsg.payload["pred"]),
            rmse_speed=rmse(y, smsg.payload["pred"]),
            rmse_hybrid=rmse(y, hc["pred"]),
            w_speed=wsol["w_speed"],
            w_batch=wsol["w_batch"],
            t_speed_train=self._train_walls.get(w, 0.0),
            t_batch_infer=bmsg.payload["wall_s"],
            t_speed_infer=smsg.payload["wall_s"],
            t_hybrid_infer=hc.wall_s + t_w,
            t_weight_solve=t_w,
        )
        self._records[w] = rec
        self._schedule(
            "hybrid_inference", wsol.wall_s + hc.wall_s, comm,
            lambda: self.bus.publish(
                T_HYBRID,
                {"window": w, "rmse_hybrid": rec.rmse_hybrid,
                 "w_speed": rec.w_speed},
                _nbytes(hc["pred"]), self.dep.site_of("hybrid_inference")))

    def _on_train(self, msg: Message) -> None:
        w = msg.payload["window"]
        comm = msg.deliver_time - msg.publish_time
        if not self._train_fits_site(comm):
            return
        out = self.stages.speed_training(
            data={"x": msg.payload["x"], "y": msg.payload["y"]},
            speed_params=self._model.params,
            batch_params=self._batch_params, key=self._keys[w])
        self._train_walls[w] = out["train_wall_s"]
        if w in self._records:
            self._records[w].t_speed_train = out["train_wall_s"]
        params_pub = out["params"]
        if self.quantized_sync:
            # the training site quantizes before the transfer, so the model
            # topic carries the int8 byte count and the edge serves the
            # QTensor tree through the int8 kernel
            params_pub = quantize_tree(out["params"],
                                       min_size=self.quant_min_size)
        pub_checksum = tree_checksum(params_pub)
        self._schedule(
            "speed_training", out.wall_s, comm,
            lambda: self.bus.publish(
                T_MODEL,
                {"window": w, "params": params_pub,
                 "eval_preds": out["eval_preds"], "eval_y": out["eval_y"],
                 "checksum": pub_checksum},
                _nbytes(params_pub), self.dep.site_of("speed_training")))

    def _on_model_sync(self, msg: Message) -> None:
        out = self.stages.model_sync(
            params=msg.payload["params"], eval_preds=msg.payload["eval_preds"],
            eval_y=msg.payload["eval_y"],
            checksum=msg.payload.get("checksum"))
        if not out["ok"] or msg.payload["window"] <= self._model.window:
            # corrupted in transit, or an out-of-order publish: the transfer
            # happened, but the model is never installed (serving stays on
            # the previous or the batch model)
            self.ledger.add("model_sync", comp_s=0.0,
                            comm_s=msg.deliver_time - msg.publish_time)
            return
        self._model = _ModelState(
            params=out["speed_params"], prev_preds=out["prev_preds"],
            prev_y=out["prev_y"], window=msg.payload["window"])
        self._schedule("model_sync", out.wall_s,
                       msg.deliver_time - msg.publish_time)

    def _on_user(self, msg: Message) -> None:
        w = msg.payload["window"]
        if w in self._inject_t:
            self.e2e_s[w] = msg.deliver_time - self._inject_t[w]

    # -- driver --------------------------------------------------------------

    def _warmup(self, stream: WindowedStream, batch_params: Params,
                seed: int) -> None:
        """Run every path once before the measured windows, so they are the
        paper's steady-state windows: a fit on window 0 (with its own key,
        ``warmup_seed``), a batch predict and, with int8 sync on, an int8
        speed predict.  Nothing it makes is published."""
        data = stream.supervised(0)
        tr = self.stages.speed_training(
            data=data, speed_params=None, batch_params=batch_params,
            key=warmup_seed(seed))
        self.stages.batch_inference(batch_params=batch_params, x=data["x"])
        if self.quantized_sync and len(data["x"]) > 0:
            self.stages.speed_inference(
                speed_params=quantize_tree(tr["params"],
                                           min_size=self.quant_min_size),
                x=data["x"])

    def run(self, stream: WindowedStream, batch_params: Params, seed: int,
            n_windows: Optional[int] = None) -> BusRunResult:
        self._reset()
        n = len(stream) if n_windows is None else min(n_windows, len(stream))
        self._batch_params = batch_params
        self._keys = window_seeds(seed, n)
        self._ys = {}
        self._warmup(stream, batch_params, seed)

        injector = BusInjector(self.kernel, self.bus, T_STREAM,
                               self.dep.site_of("data_injection"),
                               period_s=self.period)
        for w in range(n):
            data = stream.supervised(w)
            self._ys[w] = data["y"]
            self._inject_t[w] = injector.schedule_window(w, data)
        with frozen_heap():
            self.kernel.run()
        return BusRunResult(
            records=[self._records[w] for w in sorted(self._records)],
            ledger=self.ledger,
            failures=self.failures,
            n_windows=n,
            e2e_s=dict(self.e2e_s),
            message_log=self.bus.log,
            mode=str(self.stages.mode),
        )


# ---------------------------------------------------------------------------
# Fleet executors: N streams, one deployment, one stacked fit per window
# ---------------------------------------------------------------------------

# the spawn key of the streams' roots, and the salt of the batch-refresh
# roots: neither derivation meets the window keys or the warm-up key
_FLEET_SPAWN = 1
_REFRESH_SALT = 0x0BA7C4


def _gate_decision(gate: Optional[DriftGate], sid: StreamId, y: np.ndarray,
                   must: bool) -> bool:
    """One stream's retrain decision.  A stream with no serving model must
    retrain regardless of drift; the gate is told (``force_retrain``) so its
    reference window keeps tracking what the model actually trained on and
    its stats stay consistent with the executor's retrain log."""
    if gate is None:
        return True
    if must:
        gate.force_retrain(sid, y)
        return True
    return gate.decide(sid, y)


def stream_roots(key: int, n: int) -> List[int]:
    """The roots of ``n`` streams under one integer ``key``: stream ``i``'s
    is the first integer of ``SeedSequence(key, spawn_key=(1, i))``, which
    depends on ``i`` alone, not on the fleet's size."""
    return [int(np.random.SeedSequence(
        int(key), spawn_key=(_FLEET_SPAWN, i)).generate_state(1)[0])
        for i in range(n)]


def fleet_key_chains(key: Union[int, Mapping[StreamId, int]],
                     ids: List[StreamId], n: int
                     ) -> Dict[StreamId, List[int]]:
    """Per-stream training-key chains.  A mapping gives each stream's root
    explicitly; an integer derives stream ``i``'s root as
    ``stream_roots(key, S)[i]`` in fleet order.  Each root then runs
    ``window_seeds``, the chain of the single-stream executors, so stream
    ``i`` of a fleet run trains with exactly the keys of a single-stream run
    seeded with its root."""
    if isinstance(key, Mapping):
        roots = [int(key[sid]) for sid in ids]
    else:
        roots = stream_roots(key, len(ids))
    return {sid: window_seeds(root, n) for sid, root in zip(ids, roots)}


def _salted(root: int) -> int:
    return int(np.random.SeedSequence(
        [int(root), _REFRESH_SALT]).generate_state(1)[0])


def refresh_key_chains(key: Union[int, Mapping[StreamId, int]],
                       ids: List[StreamId], n: int
                       ) -> Dict[StreamId, List[int]]:
    """Per-stream key chains of the batch-model refresh: the derivation of
    ``fleet_key_chains`` from roots salted with a fixed constant, so a
    refresh at window ``t`` never reuses the speed-training key of that
    window."""
    if isinstance(key, Mapping):
        return fleet_key_chains({sid: _salted(key[sid]) for sid in ids},
                                ids, n)
    return fleet_key_chains(_salted(key), ids, n)


@dataclass
class FleetRunResult:
    """What a fleet run produced: per-stream window records plus the
    fleet-level training accounting (how many device dispatches the whole
    fleet's speed training cost, and which windows each stream's drift gate
    skipped)."""

    results: Dict[StreamId, HybridRunResult]
    train_dispatches: int
    retrain_log: Dict[StreamId, List[bool]]
    gate_stats: Optional[Dict[str, Any]]
    n_windows: int
    mode: str
    # the batch-model refresh plane, when the run had a BatchRefresh stage:
    # rounds fired, fleet dispatches spent, per-stream refresh counts, and
    # the total refresh training wall
    refresh: Optional[Dict[str, Any]] = None

    def skipped_retrains(self) -> int:
        return sum(not fired for log in self.retrain_log.values()
                   for fired in log)

    def total_retrains(self) -> int:
        return sum(fired for log in self.retrain_log.values()
                   for fired in log)

    def mean_rmse(self) -> Dict[str, float]:
        """Fleet mean of the per-stream mean RMSEs (nan when no stream has
        inference records yet, e.g. a one-window run)."""
        per = [r.mean_rmse() for r in self.results.values() if r.records]
        if not per:
            return {k: float("nan") for k in ("batch", "speed", "hybrid")}
        return {k: float(np.mean([p[k] for p in per]))
                for k in ("batch", "speed", "hybrid")}


@dataclass
class FleetBusRunResult(FleetRunResult):
    """Fleet run under the topic bus: adds the measured latency ledger,
    capacity failures, per-stream end-to-end window latency, the message
    log, every undeliverable publish, the batch and speed inference
    stages' windows served and stacked predicts spent, and each stream's
    final speed-model params (materialized).  A run that served queries
    adds every query (answers and stamps filled in) and the ``serving``
    statistics; a run with a placement controller adds ``placement``; a run
    under a fault plane adds ``chaos`` and one under a health plane
    ``health``."""

    ledger: LatencyLedger = field(default_factory=LatencyLedger)
    failures: List[str] = field(default_factory=list)
    e2e_s: Dict[StreamId, Dict[int, float]] = field(default_factory=dict)
    message_log: List[Message] = field(default_factory=list)
    # the request plane (when the run served queries): every query object
    # and the aggregate latency, QPS and dispatch statistics
    queries: List[Any] = field(default_factory=list)
    serving: Optional[Dict[str, Any]] = None
    # the fault plane's ledger (when a FaultPlane drove the run): realized
    # fault counts, rejections, quarantines, re-requests, plus every
    # undeliverable publish
    dead_letters: List[Any] = field(default_factory=list)
    chaos: Optional[Dict[str, Any]] = None
    # the elastic placement plane (when the run had a controller): its
    # decisions and events, realized migrations, the final per-stream site
    # map and the worker counts before and after
    placement: Optional[Dict[str, Any]] = None
    infer_dispatches: Optional[Dict[str, Dict[str, int]]] = None
    final_params: Optional[Dict[StreamId, Any]] = None
    # the health plane's verdict (when a HealthPlane drove the run): the
    # partition, site-down and recovered verdicts with their times, the
    # signed-sync and Byzantine-guard counters, and every adaptive
    # tightening of a threshold
    health: Optional[Dict[str, Any]] = None

    def table3(self) -> Dict[str, Dict[str, float]]:
        return self.ledger.table()

    def mean_e2e_s(self) -> float:
        vals = [v for per in self.e2e_s.values() for v in per.values()]
        return float(np.mean(vals)) if vals else float("nan")


class InProcessFleetExecutor:
    """The paper's synchronous per-window loop lifted to a fleet of streams.

    Per window ``t``: per-stream inference through the fleet-lifted stages
    (the same single-stream stage math and timing conventions as
    ``InProcessExecutor`` — a one-stream fleet reproduces its records
    exactly), then **one** whole-fleet speed-training dispatch
    (``FleetSpeedTraining`` -> ``FleetForecaster.train_fleet``) covering the
    streams whose drift gate said retrain — all of them when no gate is
    given, the paper's every-window policy.  Skipped streams keep serving
    their prior speed model and their prior Algorithm-1 eval predictions.

    ``key`` is an integer (stream ``i``'s root is ``stream_roots(key, S)
    [i]``) or a mapping of each stream's root; see ``fleet_key_chains``.

    With a :class:`BatchRefresh` stage, every gate-fired window is also
    archived, and the refresh cadence periodically retrains the *batch*
    models of streams with enough archived drifted windows — one extra
    fleet fit per refresh round, replacing those streams' batch params for
    all subsequent windows."""

    def __init__(self, stages: FleetStages, *, start_window: int = 1,
                 gate: Optional[DriftGate] = None,
                 batch_refresh: Optional[BatchRefresh] = None):
        self.stages = stages
        self.start_window = start_window
        self.gate = gate
        self.batch_refresh = batch_refresh

    def run(self, streams: Dict[StreamId, WindowedStream], batch_params: Any,
            key: Union[int, Mapping[StreamId, int]],
            n_windows: Optional[int] = None) -> FleetRunResult:
        st = self.stages
        ids = list(streams)
        n = min(len(s) for s in streams.values())
        if n_windows is not None:
            n = min(n, n_windows)
        keys = fleet_key_chains(key, ids, n)
        rf = self.batch_refresh
        rkeys = refresh_key_chains(key, ids, n) if rf is not None else {}
        if rf is not None:
            rf.reset()
        bp = resolve_fleet_params(batch_params, ids)
        fleet = FleetState()
        records: Dict[StreamId, List[WindowRecord]] = {sid: [] for sid in ids}
        retrain_log: Dict[StreamId, List[bool]] = {sid: [] for sid in ids}
        fc = st.speed_training.forecaster
        dispatches0 = fc.train_dispatches

        for t in range(n):
            data = {sid: streams[sid].supervised(t) for sid in ids}
            infer = [sid for sid in ids
                     if t >= self.start_window
                     and fleet.state(sid).speed_params is not None
                     and len(data[sid]["x"]) > 0]
            if infer:
                b = st.batch_inference(fleet={
                    sid: dict(batch_params=bp[sid], x=data[sid]["x"])
                    for sid in infer})["fleet"]
                s = st.speed_inference(fleet={
                    sid: dict(speed_params=fleet.state(sid).speed_params,
                              x=data[sid]["x"])
                    for sid in infer})["fleet"]
                w = st.weight_solve(fleet={
                    sid: dict(prev_preds=fleet.state(sid).prev_preds,
                              prev_y=fleet.state(sid).prev_y)
                    for sid in infer})["fleet"]
                h = st.hybrid_combine(fleet={
                    sid: dict(pred_speed=s[sid]["pred"],
                              pred_batch=b[sid]["pred"],
                              w_speed=w[sid]["w_speed"],
                              w_batch=w[sid]["w_batch"])
                    for sid in infer})["fleet"]
                for sid in infer:
                    y = data[sid]["y"]
                    t_w = (w[sid].wall_s
                           if st.single.weight_solve.is_dynamic
                           and fleet.state(sid).prev_preds is not None
                           else 0.0)
                    records[sid].append(WindowRecord(
                        window=t,
                        rmse_batch=rmse(y, b[sid]["pred"]),
                        rmse_speed=rmse(y, s[sid]["pred"]),
                        rmse_hybrid=rmse(y, h[sid]["pred"]),
                        w_speed=w[sid]["w_speed"],
                        w_batch=w[sid]["w_batch"],
                        t_batch_infer=b[sid].wall_s,
                        t_speed_infer=s[sid].wall_s,
                        t_hybrid_infer=h[sid].wall_s + t_w,
                        t_weight_solve=t_w,
                    ))
            # training phase: drift-gated whole-fleet dispatch
            train_ids = []
            for sid in ids:
                fire = _gate_decision(
                    self.gate, sid, data[sid]["y"],
                    must=fleet.state(sid).speed_params is None)
                retrain_log[sid].append(fire)
                if fire:
                    train_ids.append(sid)
                    if rf is not None:
                        rf.archive(sid, data[sid])
            if train_ids:
                tr = st.speed_training(
                    fleet_data={sid: data[sid] for sid in train_ids},
                    batch_params={sid: bp[sid] for sid in train_ids},
                    keys={sid: keys[sid][t] for sid in train_ids})
                for sid in train_ids:
                    out = tr["fleet"][sid]
                    ss = fleet.state(sid)
                    ss.speed_params = out["params"]
                    ss.window = t
                    if out["eval_preds"] is not None:
                        ss.prev_preds = out["eval_preds"]
                        ss.prev_y = out["eval_y"]
                    if records[sid] and records[sid][-1].window == t:
                        records[sid][-1].t_speed_train = tr["train_wall_s"]
            # cloud-side heavy retraining: the queued gated batch-model
            # refresh rides the same fleet fit on its cadence
            if rf is not None and rf.due(t):
                ref = rf(keys={sid: rkeys[sid][t] for sid in ids})
                for sid, p in ref["fleet"].items():
                    bp[sid] = p

        return FleetRunResult(
            results={sid: HybridRunResult(records=records[sid],
                                          mode=str(st.mode))
                     for sid in ids},
            # refresh dispatches ride the same forecaster counter; report
            # them under ``refresh`` so this stays speed-training-only
            train_dispatches=(fc.train_dispatches - dispatches0
                              - (rf.dispatches if rf is not None else 0)),
            retrain_log=retrain_log,
            gate_stats=self.gate.stats() if self.gate is not None else None,
            n_windows=n,
            mode=str(st.mode),
            refresh=(None if rf is None else {
                "rounds": rf.rounds,
                "dispatches": rf.dispatches,
                "refreshed": dict(rf.refreshed),
                "train_wall_s": rf.train_wall_s,
            }),
        )


class FleetBusExecutor(_BusRuntime):
    """``BusExecutor`` lifted to a fleet: N streams multiplexed over
    per-stream topics (``stream/window/<sid>`` and so on, one wildcard
    subscription per module) under **one** ``Deployment``, per-stream
    serving state in a ``FleetState``, and every stream's window-``t``
    payload aggregated into one whole-fleet call per stage: speed training
    (``FleetSpeedTraining``, one stacked fit) and batch and speed inference
    (``FleetInference``, one stacked predict).  Once the window's last
    stream message reaches a module's site, the fleet computes at once and
    the per-stream results fan back out onto their own topics, each charged
    the one shared wall.

    Fresh models publish per stream on ``model/latest/<sid>`` with that
    stream's real parameter bytes and a ``tree_checksum``; with a
    ``DriftGate``, stationary streams neither train nor transfer and keep
    serving their prior model, and the shared fit's wall goes only to the
    streams that trained.  ``quantized_sync=True`` quantizes every
    retrained stream's model at the publish boundary in one pass
    (``quantize_fleet``), ships the int8 tree with its int8 bytes, and the
    edge serves the fleet through the int8 kernel's stream axis.

    ``qps > 0`` (or an explicit ``query_trace``) turns on the request
    plane: user queries arrive open-loop on ``serve/request/<sid>``, a
    slot-recycling :class:`~repro_torch.serving.query_plane.QueryPlane`
    admits them into ``serve_slots`` fixed batch slots, and every serving
    tick answers all active slots across all streams in **one** stacked
    predict (``ServingStage``) over the device-resident serving params,
    scheduled under the serving site's worker occupancy, its answers
    published on ``serve/response/<sid>``; per-request latency and
    sustained QPS land in ``FleetBusRunResult.serving``.

    Robustness, as in the reference: ``ModelSync`` verifies each publish's
    checksum (and, under a health plane, its HMAC signature), and a corrupt
    or forged one is never installed (the sync site re-requests it on
    ``model/rerequest/<sid>``; the training site re-sends its last publish,
    at most ``max_resync`` times a (stream, window)); under a fault plane
    each aggregation arms an ``agg_timeout_s`` flush that dispatches the
    streams that arrived and quarantines a stream after
    ``quarantine_after`` missed training windows, until its sensor delivers
    again; the staleness watchdog (``_serving_params``, which every serving
    tick calls) serves the batch model for a stream whose model lags its
    context by more than ``staleness_bound`` windows and stamps those
    answers ``served_fallback``; in-flight stage work on a site that is
    down at completion is lost, and a restarted site comes back cold
    (``_on_site_restart``).  ``stage_costs`` (module -> seconds) replaces
    measured walls with fixed virtual costs, so chaos runs replay byte for
    byte under one fault seed; ``batch_refresh`` retrains batch models from
    archived drifted windows on its cadence.

    ``fault_plane`` (a :class:`~repro_torch.runtime.faults.FaultPlane`)
    injects message, site, partition and sensor faults, rewound at the
    start of every run.  ``health_plane`` (a
    :class:`~repro_torch.runtime.health.HealthPlane`) adds the
    goldpinger-style heartbeat mesh over the topology's sites, HMAC-signed
    model sync keyed from the fault plane's seed, the Byzantine guard in
    the injection path, and fault-rate-adaptive quarantine and staleness
    thresholds (the constructor's ``quarantine_after`` and
    ``staleness_bound`` become their base values).

    ``elastic=True`` (or ``"reactive"``/``"proactive"``) turns on the
    placement plane: per-stream (exact-topic) subscriptions instead of the
    one wildcard a module, and a
    :class:`~repro_torch.runtime.placement.PlacementController` (a fresh
    one a run, from ``controller_factory`` when given) driven by a periodic
    ``ctrl/tick`` beat every ``control_interval_s`` (half a window period
    by default) at the training site.  It migrates hot or queued streams
    to the cloud and cold ones back to the edge (republishing their
    subscriptions and handing their device state across,
    ``FleetState.handoff``), and grows or shrinks ``Site.workers``
    reactively from queue-depth EWMAs and proactively from its LSTM load
    forecast.  The aggregated one-predict-a-window path is untouched:
    aggregation happens above placement, so a migration only changes where
    occupancy is charged and results fan out from."""

    def __init__(
        self,
        stages: FleetStages,
        deployment: Deployment,
        topo: Topology,
        cost: Optional[CostModel] = None,
        *,
        start_window: int = 1,
        window_period_s: float = 30.0,
        strict_capacity: bool = False,
        gate: Optional[DriftGate] = None,
        quantized_sync: bool = False,
        quant_min_size: int = 64,
        qps: float = 0.0,
        serve_slots: int = 4,
        query_trace: Optional[List[Any]] = None,
        query_seed: int = 0,
        fault_plane: Optional[Any] = None,
        health_plane: Optional[Any] = None,
        stage_costs: Optional[Dict[str, float]] = None,
        staleness_bound: int = 1,
        agg_timeout_s: Optional[float] = None,
        quarantine_after: int = 2,
        max_resync: int = 3,
        elastic: Union[bool, str] = False,
        controller_factory: Optional[
            Callable[[], PlacementController]] = None,
        control_interval_s: Optional[float] = None,
        batch_refresh: Optional[BatchRefresh] = None,
    ):
        self.stages = stages
        self.dep = deployment
        self.topo = topo
        self.cost = cost or CostModel()
        self.start_window = start_window
        self.period = window_period_s
        self.strict = strict_capacity
        self.gate = gate
        self.quantized_sync = quantized_sync
        self.quant_min_size = quant_min_size
        self.qps = qps
        self.serve_slots = serve_slots
        self.query_trace = query_trace
        self.query_seed = query_seed
        self.fault_plane = fault_plane
        self.health_plane = health_plane
        self.stage_costs = stage_costs
        self.staleness_bound = staleness_bound
        self.agg_timeout_s = (agg_timeout_s if agg_timeout_s is not None
                              else 0.25 * window_period_s)
        self.quarantine_after = quarantine_after
        self.max_resync = max_resync
        # the elastic placement plane: False (static), True/"proactive"
        # (reactive + forecast-ahead scaling), or "reactive".  A fresh
        # controller is built a run, so repeated runs replay identically.
        self.elastic = elastic
        self.controller_factory = controller_factory
        self.control_interval_s = control_interval_s
        self.controller: Optional[PlacementController] = None
        self.batch_refresh = batch_refresh

    @property
    def _single_stages(self) -> PipelineStages:
        return self.stages.single

    @property
    def _serving_enabled(self) -> bool:
        return (self.qps > 0 or self.query_trace is not None) \
            and self.stages.serving is not None

    def _serving_site_name(self) -> str:
        """Where serving ticks run: an explicit ``serving`` placement when
        the deployment names one, else with speed inference (the paper's
        edge serving role), so serving contends for the same
        ``Site.workers`` pool as the inference chain."""
        try:
            return self.dep.site_of("serving")
        except KeyError:
            return self.dep.site_of("speed_inference")

    def _site(self, module: str):
        if module == "serving":
            return self.topo.sites[self._serving_site_name()]
        return super()._site(module)

    # -- per-run state -------------------------------------------------------

    def _reset(self, ids: List[StreamId]) -> None:
        self._init_runtime()
        self.ids = list(ids)
        self._fleet = FleetState()
        self._records: Dict[Tuple[StreamId, int], WindowRecord] = {}
        self._train_walls: Dict[Tuple[StreamId, int], float] = {}
        self._pending: Dict[Tuple[StreamId, int], Dict[str, Message]] = {}
        # per-stage aggregation: (kind, window) -> arrived stream messages;
        # kind in {"batch", "speed", "train"}
        self._pending_agg: Dict[Tuple[str, int], Dict[StreamId, Message]] = {}
        self._dispatched: set = set()
        self._flush_armed: set = set()
        self._quarantined: Dict[StreamId, int] = {}
        self._miss: Dict[StreamId, int] = {sid: 0 for sid in ids}
        self._last_model_pub: Dict[StreamId, Tuple[Dict[str, Any], float]] = {}
        self._resync_sent: Dict[Tuple[StreamId, int], int] = {}
        self._retrain_log: Dict[StreamId, List[bool]] = {
            sid: [] for sid in ids}
        self._inject_t: Dict[Tuple[StreamId, int], float] = {}
        self.e2e_s: Dict[StreamId, Dict[int, float]] = {sid: {} for sid in ids}
        self._ys: Dict[Tuple[StreamId, int], np.ndarray] = {}
        self._qplane: Optional[QueryPlane] = (
            QueryPlane(ids, self.serve_slots)
            if self._serving_enabled else None)
        self.queries: List[Any] = []
        self._query_lat: Dict[int, float] = {}
        self._tick_pending = False
        self._squant_bp: Dict[StreamId, Any] = {}
        # the placement plane's per-run state: each stream's current site
        # (seeded from the deployment's static pins), its live topic
        # registrations (so a migration unsubscribes exactly what it
        # subscribed), realized migrations, and the base worker counts
        # (restored after the run so one topology object is reusable)
        self._stream_site: Dict[StreamId, str] = dict(
            self.dep.stream_placement)
        self._stream_subs: Dict[StreamId, List[Tuple[str, str, Any]]] = {}
        self._migrations: List[Dict[str, Any]] = []
        self._base_workers: Dict[str, int] = {
            name: s.workers for name, s in self.topo.sites.items()}
        self._controller: Optional[PlacementController] = None
        if self.elastic:
            if self.controller_factory is not None:
                self._controller = self.controller_factory()
            else:
                self._controller = PlacementController(
                    proactive=(self.elastic != "reactive"),
                    device=self.stages.speed_training.forecaster.device)
            self.controller = self._controller
        self._wire()

    def _module_site(self, module: str, sid: Optional[StreamId] = None) -> str:
        """Where ``module`` runs for stream ``sid``: the stream's current
        elastic placement when it has one and the module migrates per
        stream, else the deployment's static site."""
        if (sid is not None and module in STREAM_MODULES
                and sid in self._stream_site):
            return self._stream_site[sid]
        return self.dep.site_of(module, sid)

    def _subscribe_stream(self, sid: StreamId) -> None:
        """Register the stream's per-stream topic subscriptions at its
        *current* site (the placement plane's replacement for the one
        wildcard a module), remembering each so a migration can republish
        them elsewhere."""
        regs: List[Tuple[str, str, Any]] = []
        for base, module, fn in (
                (T_STREAM, "batch_inference", self._on_batch),
                (T_STREAM, "speed_inference", self._on_speed),
                (T_BATCH, "hybrid_inference", self._on_part),
                (T_SPEED, "hybrid_inference", self._on_part),
                (T_MODEL, "model_sync", self._on_model_sync)):
            topic = stream_topic(base, sid)
            site = self._module_site(module, sid)
            self.bus.subscribe(topic, site, fn)
            regs.append((topic, site, fn))
        self._stream_subs[sid] = regs

    def _wire(self) -> None:
        dep, bus = self.dep, self.bus
        sub = lambda base, module, fn: bus.subscribe(
            base + "/+", dep.site_of(module), fn)
        if self.elastic:
            # per-stream (exact-topic) subscriptions for the migratable
            # inference chain: each stream message is delivered in the
            # wildcard path's order (batch, speed, then the wildcard subs
            # below), but each stream's handlers live at *its* site and can
            # be republished on migration
            for sid in self.ids:
                self._subscribe_stream(sid)
        else:
            sub(T_STREAM, "batch_inference", self._on_batch)
            sub(T_STREAM, "speed_inference", self._on_speed)
            sub(T_BATCH, "hybrid_inference", self._on_part)
            sub(T_SPEED, "hybrid_inference", self._on_part)
            sub(T_MODEL, "model_sync", self._on_model_sync)
        sub(T_STREAM, "speed_training", self._on_train)
        sub(T_STREAM, "data_sync", self._on_data_sync)
        sub(T_HYBRID, "archiving", self._on_archive)
        sub(T_HYBRID, "data_injection", self._on_user)
        # checksum-failure recovery: the sync site asks the training site to
        # re-publish a corrupted model
        sub(T_RESYNC, "speed_training", self._on_resync)
        if self._controller is not None:
            bus.subscribe(T_CTRL, self._ctrl_site_name(), self._on_ctrl_tick)
        if self.health_plane is not None:
            # the goldpinger mesh: every site monitors every other.  Each
            # site subscribes the heartbeat wildcard (deliveries from peers
            # ride the real links, so partitions and crashes cut them) and
            # its own exact-topic check beat (a loopback publish: a down
            # site's monitor goes silent).  The handlers are bookkeeping
            # only and occupy no pool worker.
            hp = self.health_plane
            for name in self.topo.sites:
                bus.subscribe(
                    T_HEALTH_HB + "/+", name,
                    lambda msg, obs=name: hp.observe_heartbeat(
                        obs, msg.payload["site"], msg.deliver_time))
                bus.subscribe(
                    stream_topic(T_HEALTH_CHECK, name), name,
                    lambda msg, obs=name: hp.check(obs, msg.deliver_time))
        if self._serving_enabled:
            # the request plane: stream windows feed the serving contexts,
            # request topics feed the admission queue, responses land back
            # at the user-facing injection site
            serve_site = self._serving_site_name()
            bus.subscribe(T_STREAM + "/+", serve_site, self._on_serve_ctx)
            bus.subscribe(T_REQUEST + "/+", serve_site, self._on_request)
            bus.subscribe(T_RESPONSE + "/+", dep.site_of("data_injection"),
                          self._on_response)

    # -- handlers ------------------------------------------------------------

    def _gather(self, kind: str, msg: Message
                ) -> Optional[Dict[StreamId, Message]]:
        """Collect window ``w``'s per-stream messages for one aggregated
        stage call (``kind`` in batch/speed/train).  Returns the complete
        set, every stream not quarantined arrived, else None.

        A delivery from a quarantined stream revives it; a delivery for an
        already-dispatched (kind, window) is a late straggler and is
        dropped; under a fault plane the first delivery arms a flush
        (``agg_timeout_s``) that dispatches whoever showed up
        (:meth:`_flush`)."""
        sid, w = msg.payload["stream"], msg.payload["window"]
        fp = self.fault_plane
        # the delivered window's y is the ground truth of (sid, w) from
        # here on: under record dropout it is shorter than the nominal y
        self._ys[(sid, w)] = msg.payload["y"]
        if sid in self._quarantined:
            del self._quarantined[sid]
            self._miss[sid] = 0
            if fp is not None:
                fp.note("quarantine_revived", self.kernel.now, sid)
        key = (kind, w)
        if key in self._dispatched:
            if fp is not None:
                fp.note("late_straggler_dropped", self.kernel.now,
                        f"{kind}:{sid}/w{w}")
            return None
        pend = self._pending_agg.setdefault(key, {})
        pend[sid] = msg
        self._miss[sid] = 0
        expected = [s for s in self.ids if s not in self._quarantined]
        if all(s in pend for s in expected):
            self._dispatched.add(key)
            return self._pending_agg.pop(key)
        if fp is not None and key not in self._flush_armed:
            self._flush_armed.add(key)
            self.kernel.after(self.agg_timeout_s,
                              lambda: self._flush(kind, w))
        return None

    def _flush(self, kind: str, w: int) -> None:
        """Aggregation timeout: dispatch the streams whose window arrived.
        Streams that missed ``quarantine_after`` consecutive training
        flushes are quarantined: later aggregations stop waiting for them,
        so one dead sensor cannot stall the fleet."""
        key = (kind, w)
        if key in self._dispatched:
            return
        self._dispatched.add(key)
        pend = self._pending_agg.pop(key, {})
        fp = self.fault_plane
        if fp is not None:
            fp.note("agg_flush", self.kernel.now,
                    f"{kind}/w{w}:{len(pend)}/{len(self.ids)}")
        hp = self.health_plane
        if kind == "train":
            for s in self.ids:
                if s in pend or s in self._quarantined:
                    continue
                self._miss[s] += 1
                if hp is not None:
                    # a missed training flush is a detected sensor fault:
                    # feed the stream's fault rate, then read the (maybe
                    # tightened) threshold back; calm pressure gives the
                    # base knob
                    hp.observe_fault("sensor", s, self.kernel.now)
                    q_after = hp.quarantine_after(s, self.kernel.now)
                else:
                    q_after = self.quarantine_after
                if self._miss[s] >= q_after:
                    self._quarantined[s] = w
                    if fp is not None:
                        fp.note("stream_quarantined", self.kernel.now,
                                f"{s}@w{w}")
        if not pend:
            return
        if kind == "train":
            self._dispatch_train(w, pend)
        else:
            self._dispatch_infer(kind, w, pend)

    def _on_batch(self, msg: Message) -> None:
        w = msg.payload["window"]
        if w < self.start_window:
            return
        pend = self._gather("batch", msg)
        if pend is not None:
            self._dispatch_infer("batch", w, pend)

    def _on_speed(self, msg: Message) -> None:
        w = msg.payload["window"]
        if w < self.start_window:
            return
        pend = self._gather("speed", msg)
        if pend is not None:
            self._dispatch_infer("speed", w, pend)

    def _dispatch_infer(self, kind: str, w: int,
                        pend: Dict[StreamId, Message]) -> None:
        # the window's arrived streams are at the inference site: one
        # stacked predict, the per-stream results fan back out, each group
        # of streams at one site charged the shared wall
        sids = [s for s in self.ids if s in pend]
        if kind == "batch":
            stage, topic = self.stages.batch_inference, T_BATCH
            out = stage(fleet={
                sid: dict(batch_params=self._bp[sid],
                          x=pend[sid].payload["x"])
                for sid in sids})["fleet"]
        else:
            stage, topic = self.stages.speed_inference, T_SPEED
            # under int8 sync a stream with no speed model yet serves the
            # batch model; beside streams that serve int8 models in the same
            # stacked predict it serves its int8 copy (as a serving tick
            # does), so the stacked tree keeps one structure.  The
            # reference stacks the float tree beside the int8 ones there
            # and raises.
            mixed = self.quantized_sync and len(
                {self._fleet.state(sid).speed_params is None
                 for sid in sids}) > 1
            out = stage(fleet={
                sid: dict(speed_params=self._fleet.state(sid).speed_params,
                          x=pend[sid].payload["x"],
                          fallback_params=(self._serving_fallback(sid)
                                           if mixed else self._bp[sid]))
                for sid in sids})["fleet"]
        wall = out[sids[0]].wall_s
        module = "batch_inference" if kind == "batch" else "speed_inference"
        groups: Dict[str, List[StreamId]] = {}
        for sid in sids:
            groups.setdefault(self._module_site(module, sid), []).append(sid)
        for site_name, gsids in groups.items():
            comm = max(pend[s].deliver_time - pend[s].publish_time
                       for s in gsids) + self.cost.ingest_s

            def publish_preds(gsids=gsids, site_name=site_name):
                for sid in gsids:
                    o = out[sid]
                    self.bus.publish(
                        stream_topic(topic, sid),
                        {"stream": sid, "window": w, "kind": kind,
                         "pred": o["pred"], "wall_s": o.wall_s,
                         "fallback": o.values.get("fallback", False)},
                        _nbytes(o["pred"]), site_name)

            self._schedule(module, wall, comm, publish_preds,
                           site_name=site_name)

    def _on_part(self, msg: Message) -> None:
        sid, w = msg.payload["stream"], msg.payload["window"]
        parts = self._pending.setdefault((sid, w), {})
        parts[msg.payload["kind"]] = msg
        if len(parts) < 2:
            return
        st = self.stages.single
        state = self._fleet.state(sid)
        bmsg, smsg = parts["batch"], parts["speed"]
        comm = max(m.deliver_time - m.publish_time for m in parts.values())
        wsol = st.weight_solve(prev_preds=state.prev_preds,
                               prev_y=state.prev_y)
        t_w = (wsol.wall_s if st.weight_solve.is_dynamic
               and state.prev_preds is not None else 0.0)
        hc = st.hybrid_combine(
            pred_speed=smsg.payload["pred"], pred_batch=bmsg.payload["pred"],
            w_speed=wsol["w_speed"], w_batch=wsol["w_batch"])
        y = self._ys[(sid, w)]
        rec = WindowRecord(
            window=w,
            rmse_batch=rmse(y, bmsg.payload["pred"]),
            rmse_speed=rmse(y, smsg.payload["pred"]),
            rmse_hybrid=rmse(y, hc["pred"]),
            w_speed=wsol["w_speed"],
            w_batch=wsol["w_batch"],
            t_speed_train=self._train_walls.get((sid, w), 0.0),
            t_batch_infer=bmsg.payload["wall_s"],
            t_speed_infer=smsg.payload["wall_s"],
            t_hybrid_infer=hc.wall_s + t_w,
            t_weight_solve=t_w,
        )
        self._records[(sid, w)] = rec
        hy_site = self._module_site("hybrid_inference", sid)
        self._schedule(
            "hybrid_inference", wsol.wall_s + hc.wall_s, comm,
            lambda: self.bus.publish(
                stream_topic(T_HYBRID, sid),
                {"stream": sid, "window": w, "rmse_hybrid": rec.rmse_hybrid,
                 "w_speed": rec.w_speed},
                _nbytes(hc["pred"]), hy_site),
            site_name=hy_site)

    def _on_train(self, msg: Message) -> None:
        w = msg.payload["window"]
        pend = self._gather("train", msg)
        if pend is not None:
            self._dispatch_train(w, pend)

    def _dispatch_train(self, w: int, pend: Dict[StreamId, Message]) -> None:
        # the window's arrived streams are at the training site: one
        # drift-gated, stream-count-bucketed fleet fit
        comm = max(m.deliver_time - m.publish_time for m in pend.values())
        if not self._train_fits_site(comm):
            return
        train_ids = []
        for s in self.ids:
            if s not in pend:
                continue
            fire = _gate_decision(
                self.gate, s, pend[s].payload["y"],
                must=self._fleet.state(s).speed_params is None)
            self._retrain_log[s].append(fire)
            if fire:
                train_ids.append(s)
                if self.batch_refresh is not None:
                    self.batch_refresh.archive(
                        s, {"x": pend[s].payload["x"],
                            "y": pend[s].payload["y"]})
        self._maybe_refresh(w)
        if not train_ids:
            return
        out = self.stages.speed_training(
            fleet_data={s: {"x": pend[s].payload["x"],
                            "y": pend[s].payload["y"]} for s in train_ids},
            batch_params={s: self._bp[s] for s in train_ids},
            keys={s: self._keys[s][w] for s in train_ids})
        for s in train_ids:
            # the shared fit's wall, charged only to the streams that
            # trained: a gate-skipped stream's record keeps t_speed_train 0
            self._train_walls[(s, w)] = out["train_wall_s"]
            if (s, w) in self._records:
                self._records[(s, w)].t_speed_train = out["train_wall_s"]

        def publish_models():
            pubs = [out["fleet"][s]["params"] for s in train_ids]
            if self.quantized_sync:
                # the publish boundary: each stacked fit output quantizes in
                # one pass, the model topics carry the int8 bytes, and the
                # edge serves the fleet through the int8 kernel
                pubs = quantize_fleet(pubs, min_size=self.quant_min_size)
            hp = self.health_plane
            for s, params_pub in zip(train_ids, pubs):
                o = out["fleet"][s]
                payload = {"stream": s, "window": w, "params": params_pub,
                           "eval_preds": o["eval_preds"],
                           "eval_y": o["eval_y"],
                           "checksum": tree_checksum(params_pub)}
                if hp is not None and hp.sync_key is not None:
                    # authenticated sync: the CRC32 catches damage in
                    # transit, the HMAC tampering (a forger can recompute
                    # the checksum but not the keyed signature)
                    payload["sig"] = sign_tree(params_pub, hp.sync_key)
                nbytes = _nbytes(params_pub)
                # the last publish, so a re-request re-sends it untrained
                self._last_model_pub[s] = (payload, nbytes)
                self.bus.publish(stream_topic(T_MODEL, s), payload, nbytes,
                                 self.dep.site_of("speed_training"))

        self._schedule("speed_training", out.wall_s, comm, publish_models)

    def _maybe_refresh(self, w: int) -> None:
        """The training site's queued batch-model refresh: when due, one
        more fleet fit retrains the batch models of the streams with enough
        archived drifted windows.  The refreshed params install at the
        scheduled completion, as a model publish does, and serve every later
        batch inference and weight solve."""
        rf = self.batch_refresh
        if rf is None or not rf.due(w) or not rf.ready():
            return
        out = rf(keys={s: self._rkeys[s][w] for s in self.ids})

        def install():
            for s, p in out["fleet"].items():
                self._bp[s] = p

        self._schedule("speed_training", out.wall_s, 0.0, install)

    def _on_model_sync(self, msg: Message) -> None:
        sid = msg.payload["stream"]
        state = self._fleet.state(sid)
        hp = self.health_plane
        # verify before the ordering guard: every corrupted delivery is
        # detected and counted, whether or not it would have installed
        out = self.stages.single.model_sync(
            params=msg.payload["params"],
            eval_preds=msg.payload["eval_preds"],
            eval_y=msg.payload["eval_y"],
            checksum=msg.payload.get("checksum"),
            signature=msg.payload.get("sig"),
            sig_key=hp.sync_key if hp is not None else None)
        if not out["ok"]:
            # the transfer happened, but a corrupt or forged model is never
            # served; ask the training site to re-send (its cached publish
            # carries a valid signature)
            self.ledger.add("model_sync", comp_s=0.0,
                            comm_s=msg.deliver_time - msg.publish_time)
            if hp is not None:
                hp.observe_fault("sync", sid, self.kernel.now)
            if out.values.get("forged") and self.fault_plane is not None:
                self.fault_plane.note("sync_sig_rejected", self.kernel.now,
                                      f"{sid}/w{msg.payload['window']}")
            self._request_resync(sid, msg.payload["window"])
            return
        if msg.payload["window"] <= state.window:
            # never install an older model over a newer one
            self.ledger.add("model_sync", comp_s=0.0,
                            comm_s=msg.deliver_time - msg.publish_time)
            return
        state.speed_params = out["speed_params"]
        state.prev_preds = out["prev_preds"]
        state.prev_y = out["prev_y"]
        state.window = msg.payload["window"]
        self._schedule("model_sync", out.wall_s,
                       msg.deliver_time - msg.publish_time,
                       site_name=self._module_site("model_sync", sid))

    def _request_resync(self, sid: StreamId, w: int) -> None:
        sent = self._resync_sent.get((sid, w), 0)
        if sent >= self.max_resync:
            if self.fault_plane is not None:
                self.fault_plane.note("resync_gave_up", self.kernel.now,
                                      f"{sid}/w{w}")
            return
        self._resync_sent[(sid, w)] = sent + 1
        self.bus.publish(stream_topic(T_RESYNC, sid),
                         {"stream": sid, "window": w}, 64.0,
                         self._module_site("model_sync", sid))

    def _on_resync(self, msg: Message) -> None:
        cached = self._last_model_pub.get(msg.payload["stream"])
        if cached is None:
            return
        payload, nbytes = cached
        if payload["window"] < msg.payload["window"]:
            return
        self.bus.publish(stream_topic(T_MODEL, payload["stream"]), payload,
                         nbytes, self.dep.site_of("speed_training"))

    def _on_site_restart(self, site_name: str) -> None:
        """Cold restart after a crash: the worker pool forgets its queue (a
        restarted box has no backlog), and if the model-sync module lived
        there its installed serving state is gone: every stream falls back
        to the batch model until the next sync lands."""
        self._free.pop(site_name, None)
        for sid in self.ids:
            if self._module_site("model_sync", sid) != site_name:
                continue
            st = self._fleet.state(sid)
            st.speed_params = None
            st.prev_preds = None
            st.prev_y = None
            st.window = -1

    def _on_user(self, msg: Message) -> None:
        sid, w = msg.payload["stream"], msg.payload["window"]
        if (sid, w) in self._inject_t:
            self.e2e_s[sid][w] = msg.deliver_time - self._inject_t[(sid, w)]

    # -- the elastic placement plane -----------------------------------------

    def _ctrl_site_name(self) -> str:
        """Where the placement controller runs: the training site, the one
        place with a fleet-wide view (under the integrated deployment, the
        cloud)."""
        return self.dep.site_of("speed_training")

    def _drift_hotness(self, sid: StreamId, recent: int = 4) -> float:
        """The share of the stream's recent training windows the
        ``DriftGate`` actually retrained.  Without a gate there is no drift
        signal (the fleet retrains every window), so hotness is 0, not 1:
        migration then keys off queue depth alone."""
        if self.gate is None:
            return 0.0
        log = self._retrain_log.get(sid, [])[-recent:]
        return float(np.mean(log)) if log else 0.0

    def _serving_queue_s(self) -> Dict[StreamId, float]:
        """Seconds of serving work queued in the request plane, per stream:
        each submitted but unadmitted query costs one slot's share of the
        last serving tick's wall.  This is the queue the site's worker pool
        cannot see (the request plane admits at tick boundaries, one tick
        in flight), so a saturated serving site piles its backlog up here
        first."""
        out: Dict[StreamId, float] = {sid: 0.0 for sid in self.ids}
        if not self._serving_enabled:
            return out
        walls = self.ledger.comp.get("serving", [])
        per_q = (walls[-1] if walls else 0.0) / max(self.serve_slots, 1)
        for q in self._qplane.sched.queue:
            out[q.stream] = out.get(q.stream, 0.0) + per_q
        return out

    def _on_ctrl_tick(self, msg: Message) -> None:
        """One control interval: snapshot the site and stream signals, run
        the controller's policy, apply its worker counts and migrations.
        The controller's compute goes straight to the ledger
        (``stage_costs["placement_controller"]`` can fix it) and occupies no
        pool worker: the control plane must not perturb the data plane it
        observes."""
        ctl = self._controller
        if ctl is None:
            return
        t = self.kernel.now
        qdepth = self._serving_queue_s()
        serve_site = (self._serving_site_name() if self._serving_enabled
                      else None)
        sites = [SiteSignal(name=s.name, kind=s.kind, workers=s.workers,
                            base_workers=self._base_workers[s.name],
                            backlog_s=self._backlog_s(s.name)
                            + (sum(qdepth.values())
                               if s.name == serve_site else 0.0))
                 for s in self.topo.sites.values()]
        for s in sites:
            self.ledger.sample_depth(s.name, t, s.backlog_s)
        streams = []
        for sid in self.ids:
            site = self._module_site("speed_inference", sid)
            streams.append(StreamSignal(
                sid=sid, site=site, drift_hot=self._drift_hotness(sid),
                queue_s=self._backlog_s(site) + qdepth[sid]))
        t0 = time.perf_counter()
        dec = ctl.step(t, sites, streams)
        wall = time.perf_counter() - t0
        sc = self.stage_costs or {}
        self.ledger.add("placement_controller",
                        comp_s=sc.get("placement_controller", wall))
        for name, workers in dec.workers.items():
            self.topo.sites[name].workers = workers
        for sid, target in dec.migrations.items():
            self._migrate(sid, target, t)

    def _migrate(self, sid: StreamId, target: str, t: float) -> None:
        """Move one stream's inference chain to ``target``: republish its
        per-stream topic subscriptions at the new site and hand its device
        state across (``FleetState.handoff`` copies a stream's view of a
        stacked fit output into params the stream owns; the transfer rides
        the sites' link in the ledger).  Messages matched before the move
        still run their handler, so nothing is dropped; new publishes route
        to the new site."""
        old = self._module_site("speed_inference", sid)
        if target == old:
            return
        nbytes = self._fleet.handoff(sid)
        for topic, site, fn in self._stream_subs.get(sid, []):
            self.bus.unsubscribe(topic, site, fn)
        self._stream_site[sid] = target
        self._subscribe_stream(sid)
        self.ledger.add("placement_migration", comp_s=0.0,
                        comm_s=self.topo.link(old, target)
                        .transfer_time(nbytes))
        self._migrations.append({"t": t, "sid": sid, "from": old,
                                 "to": target, "state_nbytes": nbytes})

    # -- the request plane: the serving set and its staleness watchdog -------

    def _serving_fallback(self, sid: StreamId) -> Params:
        """What a stream serves before its first model sync: the batch
        model, quantized once (and cached) under int8 sync, so the fleet's
        stacked serving tree keeps one structure whatever mix of synced and
        unsynced streams it holds."""
        if not self.quantized_sync:
            return self._bp[sid]
        p = self._squant_bp.get(sid)
        if p is None:
            p = self._squant_bp[sid] = quantize_tree(
                self._bp[sid], min_size=self.quant_min_size)
        return p

    def _serving_params(self, context_window: Mapping[StreamId, int]
                        ) -> Tuple[List[Params], Dict[StreamId, int],
                                   Dict[StreamId, bool]]:
        """The serving set in fleet order: each stream's installed speed
        model (a ``FleetParamView`` under float sync, an int8 tree under
        int8 sync) or its batch fallback, the training window each model
        came from, and whether each stream serves the fallback.

        The staleness watchdog: a stream whose installed model lags its
        freshest context window (``context_window``, which the request
        plane tracks) by more than ``staleness_bound`` windows serves the
        batch model instead of an ever staler speed model.  Under a health
        plane the bound adapts: link suspicion or sync rejections tighten
        it toward the floor, so serving flips to the fallback sooner when
        fresh models are least likely to arrive; calm pressure gives the
        base bound."""
        params: List[Params] = []
        windows: Dict[StreamId, int] = {}
        fallback: Dict[StreamId, bool] = {}
        hp = self.health_plane
        for sid in self.ids:
            st = self._fleet.state(sid)
            ctxw = context_window[sid]
            bound = (hp.staleness_bound(sid, self.kernel.now)
                     if hp is not None else self.staleness_bound)
            stale = st.window >= 0 and ctxw - st.window > bound
            use_fb = st.speed_params is None or stale
            if stale and self.fault_plane is not None:
                self.fault_plane.note(
                    "staleness_fallback", self.kernel.now,
                    f"{sid}:ctx w{ctxw} vs model w{st.window}")
            params.append(self._serving_fallback(sid) if use_fb
                          else st.speed_params)
            windows[sid] = st.window
            fallback[sid] = use_fb
        return params, windows, fallback

    def _on_serve_ctx(self, msg: Message) -> None:
        self._qplane.observe_window(
            msg.payload["stream"], msg.payload["x"], msg.payload["window"])
        self._maybe_tick()

    def _on_request(self, msg: Message) -> None:
        q = msg.payload["query"]
        self._qplane.submit(q)
        self.queries.append(q)
        self._maybe_tick()

    def _on_response(self, msg: Message) -> None:
        q = msg.payload["query"]
        self._query_lat[q.uid] = msg.deliver_time - q.arrived_at

    def _maybe_tick(self) -> None:
        """Start a serving tick unless one is in flight (slots stay
        occupied until the running tick's virtual completion: admission and
        retirement happen at tick boundaries, never mid-predict).  A tick
        is one ``ServingStage`` call, one stacked predict for every active
        slot of every stream, charged under the serving site's worker
        occupancy; at its completion the finished queries publish on
        ``serve/response/<sid>``."""
        if not self._serving_enabled or self._tick_pending:
            return
        plane = self._qplane
        plane.admit(self.kernel.now)
        batch = plane.build_batch()
        if batch is None:
            return
        by_stream, xs = batch
        self._tick_pending = True
        params_seq, model_windows, fallback = self._serving_params(
            {sid: plane.context_window(sid) for sid in self.ids})
        out = self.stages.serving(params_seq=params_seq, xs=xs)
        plane.apply(by_stream, out["preds"], model_windows,
                    fallback=fallback)
        serve_site = self._serving_site_name()

        def finish():
            self._tick_pending = False
            for q in plane.retire(self.kernel.now):
                self.bus.publish(
                    stream_topic(T_RESPONSE, q.stream),
                    {"stream": q.stream, "query": q},
                    _nbytes(np.asarray(q.answer, np.float32)), serve_site)
            self._maybe_tick()

        self._schedule("serving", out.wall_s, 0.0, finish)

    # -- the run -------------------------------------------------------------

    def _warmup(self, streams: Dict[StreamId, WindowedStream]) -> None:
        """Run every path once before the measured windows (the whole
        fleet's fit on window 0 with its window-0 keys, and the stacked
        batch and speed predicts; with int8 sync the int8 speed predict),
        so they are steady-state windows.  Outside the event loop: the drift
        gate never sees it, and the dispatch counters are read after it."""
        data = {sid: streams[sid].supervised(0) for sid in self.ids}
        tr = self.stages.speed_training(
            fleet_data=data, batch_params=self._bp,
            keys={sid: self._keys[sid][0] for sid in self.ids})
        if all(len(data[sid]["x"]) > 0 for sid in self.ids):
            self.stages.batch_inference(fleet={
                sid: dict(batch_params=self._bp[sid], x=data[sid]["x"])
                for sid in self.ids})
            sp_list = [tr["fleet"][sid]["params"] for sid in self.ids]
            if self.quantized_sync:
                sp_list = quantize_fleet(sp_list,
                                         min_size=self.quant_min_size)
            sp = dict(zip(self.ids, sp_list))
            self.stages.speed_inference(fleet={
                sid: dict(speed_params=sp[sid], x=data[sid]["x"],
                          fallback_params=self._bp[sid])
                for sid in self.ids})

    def _warmup_serving(self, streams: Dict[StreamId, WindowedStream]) -> None:
        """Run the serving tick's row buckets (1 to ``serve_slots``, powers
        of two) once before the measured ticks, so no measured tick pays a
        first allocation: a tick batches at most ``serve_slots`` rows a
        stream, and the zero-row streams ride the same stacked predict.
        The counters are read after this, as after the training warm-up."""
        ref = None
        for sid in self.ids:
            x = np.asarray(streams[sid].supervised(0)["x"])
            if len(x) > 0:
                ref = np.asarray(x[-1])
                break
        if ref is None:
            return
        params_seq = [self._serving_fallback(sid) for sid in self.ids]
        k = 1
        while k <= max(self.serve_slots, 1):
            xs = [np.repeat(ref[None], k, axis=0)] + [
                np.zeros((0,) + ref.shape, ref.dtype)
                for _ in range(len(self.ids) - 1)]
            self.stages.serving(params_seq=params_seq, xs=xs)
            k *= 2

    def _serving_stats(self, trace: List[Any], ticks: int,
                       dispatches: int) -> Dict[str, Any]:
        """The request plane's statistics over ``trace``: answered and
        starved counts, ticks and stacked predicts, offered and sustained
        QPS, the watchdog's fallback share and worst served staleness, and
        the latency percentiles."""
        lat = self._query_lat
        answered = [q for q in trace if q.uid in lat]
        arr = [q.arrived_at for q in trace]
        offered = ((len(trace) - 1) / (max(arr) - min(arr))
                   if len(trace) > 1 and max(arr) > min(arr)
                   else float("inf"))
        if answered:
            span = (max(q.arrived_at + lat[q.uid] for q in answered)
                    - min(arr))
            sustained = (len(answered) / span if span > 0
                         else float("inf"))
        else:
            sustained = 0.0
        staleness = [q.context_window - q.model_window for q in answered
                     if not q.served_fallback and q.model_window >= 0
                     and q.context_window >= 0]
        return {
            "n_requests": len(trace),
            "n_answered": len(answered),
            "n_starved": len(trace) - len(answered),
            "ticks": ticks,
            "dispatches": dispatches,
            "dispatches_per_tick": (dispatches / ticks if ticks
                                    else float("nan")),
            "offered_qps": offered,
            "sustained_qps": sustained,
            "slots": self.serve_slots,
            # the watchdog's envelope: how often serving fell back to the
            # batch model, and the worst model lag served from a speed
            # model (fallback answers excluded: they are the bound working)
            "fallback_frac": (sum(q.served_fallback for q in answered)
                              / len(answered) if answered else 0.0),
            "max_staleness": max(staleness, default=0),
            **latency_stats([lat[q.uid] for q in answered]),
        }

    def run(self, streams: Dict[StreamId, WindowedStream], batch_params: Any,
            key: Union[int, Mapping[StreamId, int]],
            n_windows: Optional[int] = None) -> FleetBusRunResult:
        ids = list(streams)
        fp = self.fault_plane
        if fp is not None:
            # rewind the plane so repeated runs under one seed replay the
            # identical fault schedule, then wire it into the run
            fp.reset()
            fp.on_restart(self._on_site_restart)
        self._reset(ids)
        if fp is not None:
            fp.install(self.kernel)
        hp = self.health_plane
        if hp is not None:
            # rewind like the fault plane, then bind this run's topology,
            # cadence, base thresholds and the seed-derived signing key
            hp.reset()
            hp.bind(sites=list(self.topo.sites),
                    hb_interval_s=hp.cfg.hb_interval_s or 0.5 * self.period,
                    halflife_s=hp.cfg.rate_halflife_s or 2.0 * self.period,
                    quarantine_after=self.quarantine_after,
                    staleness_bound=self.staleness_bound,
                    sync_seed=fp.seed if fp is not None else 0)
        n = min(len(s) for s in streams.values())
        if n_windows is not None:
            n = min(n, n_windows)
        self._bp = resolve_fleet_params(batch_params, ids)
        self._keys = fleet_key_chains(key, ids, n)
        if self.batch_refresh is not None:
            self.batch_refresh.reset()
            self._rkeys = refresh_key_chains(key, ids, n)
        ms = self.stages.single.model_sync
        rejected0, verified0 = ms.corrupt_rejected, ms.verified
        forged0 = ms.forged_rejected
        self._warmup(streams)
        trace: List[Any] = []
        if self._serving_enabled:
            self._warmup_serving(streams)
            trace = self.query_trace
            if trace is None:
                # open-loop load for the whole run past the first window
                # (serving needs a context, so arrivals start at period)
                n_req = max(1, int(round(self.qps * self.period
                                         * max(n - 1, 1))))
                trace = open_loop_trace(ids, self.qps, n_req,
                                        start=self.period,
                                        seed=self.query_seed)
            inj_site = self.dep.site_of("data_injection")
            for q in trace:
                self.kernel.at(q.arrived_at, lambda q=q: self.bus.publish(
                    stream_topic(T_REQUEST, q.stream),
                    {"stream": q.stream, "query": q}, 256.0, inj_site))
        fc = self.stages.speed_training.forecaster
        dispatches0 = fc.train_dispatches
        srv = self.stages.serving
        ticks0 = srv.ticks if srv is not None else 0
        sdisp0 = srv.dispatches if srv is not None else 0
        bi, si = self.stages.batch_inference, self.stages.speed_inference
        infer0 = {"batch": (bi.ticks, bi.dispatches),
                  "speed": (si.ticks, si.dispatches)}

        if self._controller is not None:
            # the control plane's beat: a periodic ctrl/tick publish the
            # controller subscribes to at its site (loopback delivery), for
            # the duration of the run
            interval = self.control_interval_s or 0.5 * self.period
            ctrl_site = self._ctrl_site_name()
            k = 1
            while k * interval <= n * self.period + interval:
                self.kernel.at(
                    k * interval,
                    lambda k=k: self.bus.publish(
                        T_CTRL, {"tick": k}, 64.0, ctrl_site))
                k += 1

        if hp is not None:
            # the health plane's beats: every site publishes heartbeats on
            # health/hb/<site> (cross-site deliveries ride the real links,
            # so a partition or a crash silences them) and its own loopback
            # check beat half an interval later, when every healthy peer's
            # heartbeat has arrived.  The fault plane loses a down site's
            # publishes, so a dead site's monitor goes quiet with it.
            hb = hp.cfg.hb_interval_s or 0.5 * self.period
            horizon = n * self.period + hb
            for name in self.topo.sites:
                k = 1
                while k * hb <= horizon:
                    self.kernel.at(
                        k * hb,
                        lambda name=name, k=k: self.bus.publish(
                            stream_topic(T_HEALTH_HB, name),
                            {"site": name, "k": k}, 32.0, name))
                    self.kernel.at(
                        (k + 0.5) * hb,
                        lambda name=name: self.bus.publish(
                            stream_topic(T_HEALTH_CHECK, name), {},
                            32.0, name))
                    k += 1

        for sid in ids:
            injector = BusInjector(self.kernel, self.bus, T_STREAM,
                                   self.dep.site_of("data_injection"),
                                   period_s=self.period, stream_id=sid,
                                   fault_plane=fp, health_plane=hp)
            for w in range(n):
                data = streams[sid].supervised(w)
                self._ys[(sid, w)] = data["y"]
                self._inject_t[(sid, w)] = injector.schedule_window(w, data)
        with frozen_heap():
            self.kernel.run()

        serving_stats = None
        if self._serving_enabled and trace:
            serving_stats = self._serving_stats(
                trace, srv.ticks - ticks0, srv.dispatches - sdisp0)

        results = {}
        for sid in ids:
            recs = [self._records[(s, w)]
                    for (s, w) in sorted(self._records) if s == sid]
            results[sid] = HybridRunResult(records=recs,
                                           mode=str(self.stages.mode))
        placement = None
        if self._controller is not None:
            # report the realized worker counts, then restore the base ones
            # so one Topology object can host the next run unchanged
            final_workers = {name: s.workers
                             for name, s in self.topo.sites.items()}
            for name, wk in self._base_workers.items():
                self.topo.sites[name].workers = wk
            placement = {
                "mode": ("reactive" if self.elastic == "reactive"
                         else "proactive"),
                "control_interval_s": (self.control_interval_s
                                       or 0.5 * self.period),
                "controller": self._controller.stats(),
                "migrations": list(self._migrations),
                "stream_site": {
                    sid: self._module_site("speed_inference", sid)
                    for sid in ids},
                "base_workers": dict(self._base_workers),
                "final_workers": final_workers,
            }
        final_params = {}
        for sid in ids:
            p = self._fleet.state(sid).speed_params
            final_params[sid] = (materialize_params(p) if p is not None
                                 else None)
        chaos = None
        if fp is not None:
            chaos = {
                "fault_stats": dict(fp.stats),
                "n_fault_events": len(fp.events),
                "dead_letters": len(self.bus.dead_letters),
                "quarantined": dict(self._quarantined),
                "corrupt_rejected": ms.corrupt_rejected - rejected0,
                "checksum_verified": ms.verified - verified0,
                "forged_rejected": ms.forged_rejected - forged0,
                "resync_requests": sum(self._resync_sent.values()),
            }
        rf = self.batch_refresh
        return FleetBusRunResult(
            results=results,
            # refresh fits share the forecaster's counter; they are
            # reported under ``refresh``
            train_dispatches=(fc.train_dispatches - dispatches0
                              - (rf.dispatches if rf is not None else 0)),
            retrain_log={sid: list(log)
                         for sid, log in self._retrain_log.items()},
            gate_stats=self.gate.stats() if self.gate is not None else None,
            n_windows=n,
            mode=str(self.stages.mode),
            refresh=(None if rf is None else {
                "rounds": rf.rounds,
                "dispatches": rf.dispatches,
                "refreshed": dict(rf.refreshed),
                "train_wall_s": rf.train_wall_s,
            }),
            ledger=self.ledger,
            failures=self.failures,
            e2e_s={sid: dict(per) for sid, per in self.e2e_s.items()},
            message_log=self.bus.log,
            queries=list(self.queries),
            serving=serving_stats,
            dead_letters=list(self.bus.dead_letters),
            chaos=chaos,
            placement=placement,
            infer_dispatches={
                kind: {"ticks": st.ticks - infer0[kind][0],
                       "dispatches": st.dispatches - infer0[kind][1]}
                for kind, st in (("batch", bi), ("speed", si))},
            final_params=final_params,
            health=hp.summary() if hp is not None else None,
        )
