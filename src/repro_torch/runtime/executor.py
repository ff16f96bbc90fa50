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

The fleet executors come with the fleet slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.hybrid import HybridRunResult, WindowRecord
from repro_torch.core.stages import PipelineStages
from repro_torch.core.weighting import rmse
from repro_torch.core.windows import WindowedStream
from repro_torch.runtime.bus import (
    CapacityError,
    EventKernel,
    Message,
    TopicBus,
    Topology,
)
from repro_torch.runtime.deployment import Deployment
from repro_torch.runtime.latency import CostModel, LatencyLedger
from repro_torch.runtime.modules import (
    T_BATCH,
    T_HYBRID,
    T_MODEL,
    T_SPEED,
    T_STREAM,
)
from repro_torch.serving.quantize import (
    quantize_tree,
    tree_checksum,
    tree_nbytes,
)
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


class _BusRuntime:
    """Shared machinery of the bus-driven executors: the event kernel +
    topic bus + latency ledger lifecycle, the site scheduler that rescales
    measured walls to a site's hardware class and queues work behind
    earlier work on the site's worker pool, the training capacity model,
    and the stage-agnostic handlers.  Subclasses provide ``dep``, ``topo``,
    ``cost``, ``strict`` and ``_single_stages``.  An optional
    ``fault_plane`` and ``stage_costs`` are read with ``getattr``: the
    chaos slice attaches them."""

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
