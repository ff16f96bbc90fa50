r"""The topics of the six paper modules wired onto the topic bus, plus the
cloud back-end (speed training + archiving), reproducing Fig. 4's
orchestration:

  stream -> data_injection --(stream topic)--> batch/speed inference (async)
                               |                    \-> hybrid inference
                               |--> data_sync -> archiving (cloud)
                               \--> speed_training -> model publish
  model publish --(model topic)--> model_sync (edge) -> next-window speed model

``BusExecutor`` subscribes the stages to these topics; the fleet executor
multiplexes them per stream (``stream_topic``) and adds ``T_RESYNC``, the
sync site's re-request of a model whose checksum failed, the request plane's
``T_REQUEST`` and ``T_RESPONSE``, the placement controller's beat
``T_CTRL``, and the health plane's heartbeats (``T_HEALTH_HB``, one topic a
site) and monitor check beats (``T_HEALTH_CHECK``).

``EdgeCloudSimulation`` is the calibrated discrete-event simulation of the
launcher's default mode (paper Table 3): each module's computation is a
``CostModel`` constant rescaled to its site, its communication the bus's
delivery time.  Latency is accounted per module as (computation,
communication) exactly like the paper's Table 3; speed training placed on a
site with insufficient memory is a failure, or raises ``CapacityError``
with ``strict_capacity`` (the Pi OOM result).  It runs on the host only and
draws nothing, so its tables and message log are the reference's bit for
bit for the same ``CostModel``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from repro_torch.runtime.bus import (
    CapacityError,
    EventKernel,
    Message,
    Topology,
    TopicBus,
)
from repro_torch.runtime.deployment import Deployment
from repro_torch.runtime.latency import CostModel, LatencyLedger

T_STREAM = "stream/window"
T_BATCH = "results/batch"
T_SPEED = "results/speed"
T_HYBRID = "results/hybrid"
T_MODEL = "model/latest"
T_RESYNC = "model/rerequest"
T_REQUEST = "serve/request"
T_RESPONSE = "serve/response"
T_CTRL = "ctrl/tick"  # the elastic placement controller's control-plane beat
T_HEALTH_HB = "health/hb"  # per-site heartbeats: health/hb/<site>
T_HEALTH_CHECK = "health/check"  # per-site monitor check beat (loopback)


def stream_topic(base: str, stream_id: str) -> str:
    """Per-stream multiplexing of a base topic: ``stream/window`` ->
    ``stream/window/t03``.  Fleet executors subscribe ``base + "/+"`` (the
    bus's single-level wildcard) to receive every stream of a fleet with
    one subscription."""
    return f"{base}/{stream_id}"


@dataclass
class SimulationResult:
    ledger: LatencyLedger
    failures: List[str]
    n_windows: int
    message_log: List[Message]

    def table3(self) -> Dict[str, Dict[str, float]]:
        return self.ledger.table()


class EdgeCloudSimulation:
    """One deployment modality driven for ``n_windows`` stream windows."""

    def __init__(
        self,
        deployment: Deployment,
        topo: Topology,
        cost: CostModel,
        *,
        dynamic_weighting: bool = True,
        window_period_s: float = 30.0,
        strict_capacity: bool = False,
    ):
        self.dep = deployment
        self.topo = topo
        self.cost = cost
        self.dynamic = dynamic_weighting
        self.period = window_period_s
        self.strict = strict_capacity
        self.kernel = EventKernel()
        self.bus = TopicBus(self.kernel, topo)
        self.ledger = LatencyLedger()
        self.failures: List[str] = []
        self._pending_hybrid: Dict[int, Dict[str, Message]] = {}
        self._wire()

    # -- helpers -------------------------------------------------------------

    def _site(self, module: str):
        return self.topo.sites[self.dep.site_of(module)]

    def _compute(self, module: str, seconds: float) -> float:
        site = self._site(module)
        t = self.cost.on(site.compute_scale, seconds)
        # resource contention (paper Table 3: edge-centric inference is much
        # slower than integrated despite identical placement — the per-window
        # speed training job steals the Pi's cores)
        if (
            module != "speed_training"
            and site.kind == "edge"
            and self._site("speed_training").name == site.name
        ):
            # the attempt alone thrashes the Pi, whether or not it OOMs
            t *= 1.5
        return t

    # -- module handlers -----------------------------------------------------

    def _wire(self) -> None:
        dep = self.dep
        self.bus.subscribe(T_STREAM, dep.site_of("batch_inference"), self._on_batch)
        self.bus.subscribe(T_STREAM, dep.site_of("speed_inference"), self._on_speed)
        self.bus.subscribe(T_STREAM, dep.site_of("speed_training"), self._on_train)
        self.bus.subscribe(T_STREAM, dep.site_of("data_sync"), self._on_data_sync)
        self.bus.subscribe(T_BATCH, dep.site_of("hybrid_inference"), self._on_part)
        self.bus.subscribe(T_SPEED, dep.site_of("hybrid_inference"), self._on_part)
        self.bus.subscribe(T_HYBRID, dep.site_of("archiving"), self._on_archive)
        self.bus.subscribe(T_MODEL, dep.site_of("model_sync"), self._on_model_sync)

    def _on_batch(self, msg: Message) -> None:
        comm_in = msg.deliver_time - msg.publish_time + self.cost.ingest_s
        dur = self._compute("batch_inference", self.cost.batch_infer_s)
        w = msg.payload["window"]

        def done():
            self.ledger.add("batch_inference", comp_s=dur, comm_s=comm_in)
            self.bus.publish(T_BATCH, {"window": w, "kind": "batch"},
                             self.cost.result_nbytes,
                             self.dep.site_of("batch_inference"))

        self.kernel.after(dur, done)

    def _on_speed(self, msg: Message) -> None:
        comm_in = msg.deliver_time - msg.publish_time + self.cost.ingest_s
        dur = self._compute("speed_inference", self.cost.speed_infer_s)
        w = msg.payload["window"]

        def done():
            self.ledger.add("speed_inference", comp_s=dur, comm_s=comm_in)
            self.bus.publish(T_SPEED, {"window": w, "kind": "speed"},
                             self.cost.result_nbytes,
                             self.dep.site_of("speed_inference"))

        self.kernel.after(dur, done)

    def _on_part(self, msg: Message) -> None:
        w = msg.payload["window"]
        parts = self._pending_hybrid.setdefault(w, {})
        parts[msg.payload["kind"]] = msg
        if len(parts) < 2:
            return
        comm_in = max(m.deliver_time - m.publish_time for m in parts.values())
        secs = self.cost.hybrid_combine_s + (
            self.cost.weight_solve_s if self.dynamic else 0.0
        )
        dur = self._compute("hybrid_inference", secs)

        def done():
            self.ledger.add("hybrid_inference", comp_s=dur, comm_s=comm_in)
            self.bus.publish(T_HYBRID, {"window": w},
                             self.cost.result_nbytes,
                             self.dep.site_of("hybrid_inference"))

        self.kernel.after(dur, done)

    def _on_archive(self, msg: Message) -> None:
        comm_in = msg.deliver_time - msg.publish_time
        self.ledger.add("archiving", comp_s=0.0, comm_s=comm_in)

    def _on_data_sync(self, msg: Message) -> None:
        # raw-data archiving to object storage (S3 analog)
        link = self.topo.link(self.dep.site_of("data_sync"),
                              self.dep.site_of("archiving"))
        self.ledger.add("data_sync", comp_s=0.0,
                        comm_s=link.transfer_time(self.cost.window_nbytes))

    def _on_train(self, msg: Message) -> None:
        comm_in = msg.deliver_time - msg.publish_time
        site = self._site("speed_training")
        if self.cost.train_memory_bytes > site.memory_bytes:
            self.failures.append(
                f"speed_training OOM on {site.name}: needs "
                f"{self.cost.train_memory_bytes/1e9:.1f} GB > "
                f"{site.memory_bytes/1e9:.1f} GB"
            )
            if self.strict:
                raise CapacityError(self.failures[-1])
            return
        dur = self._compute("speed_training", self.cost.speed_train_s)
        w = msg.payload["window"]

        def done():
            self.ledger.add("speed_training", comp_s=dur, comm_s=comm_in)
            self.bus.publish(T_MODEL, {"window": w}, self.cost.model_nbytes,
                             self.dep.site_of("speed_training"))

        self.kernel.after(dur, done)

    def _on_model_sync(self, msg: Message) -> None:
        # pre-signed-URL download of the fresh speed model to the edge
        self.ledger.add("model_sync", comp_s=0.0,
                        comm_s=msg.deliver_time - msg.publish_time)

    # -- run -------------------------------------------------------------------

    def run(self, n_windows: int) -> SimulationResult:
        inj_site = self.dep.site_of("data_injection")
        for w in range(n_windows):
            self.kernel.at(
                w * self.period,
                lambda w=w: self.bus.publish(
                    T_STREAM, {"window": w}, self.cost.window_nbytes, inj_site
                ),
            )
        self.kernel.run()
        return SimulationResult(
            ledger=self.ledger,
            failures=self.failures,
            n_windows=n_windows,
            message_log=self.bus.log,
        )
