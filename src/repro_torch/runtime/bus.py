"""Deterministic discrete-event runtime: sites, links, and an MQTT-style
topic bus.

This is the port's stand-in for the paper's AWS wiring (IoT Core MQTT,
Greengrass, Lambda triggers): a heapq event kernel delivers published
payloads to subscribers after ``link.latency + bytes / link.bandwidth``
seconds; modules schedule compute work on their site with explicit durations.
Everything is deterministic so tests can assert exact orderings.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple


class CapacityError(RuntimeError):
    """A module exceeded its site's memory budget (the paper's edge-centric
    speed-training OOM, Sec. 6.2)."""


@dataclass
class Site:
    """A compute location.

    ``compute_scale`` rescales *measured-on-this-container* wall-times to the
    site's hardware class (e.g. Raspberry Pi 4 ~0.25x of a c5 vCPU);
    ``memory_bytes`` is the capacity model used for the OOM reproduction.
    ``workers`` is how many modules the site can execute concurrently
    (``BusExecutor`` site occupancy; the calibrated simulation ignores it).
    ``workers`` is mutable: the elastic placement controller grows and
    shrinks it at runtime, and executors resize their worker pools lazily.
    """

    name: str
    kind: str  # "edge" | "cloud"
    compute_scale: float = 1.0
    memory_bytes: float = 4e9
    workers: int = 1


@dataclass(frozen=True)
class Link:
    latency_s: float
    bandwidth_Bps: float

    def transfer_time(self, nbytes: float) -> float:
        return self.latency_s + nbytes / self.bandwidth_Bps


@dataclass
class Topology:
    sites: Dict[str, Site]
    links: Dict[Tuple[str, str], Link]
    loopback: Link = field(default_factory=lambda: Link(1e-4, 1e10))

    def link(self, src: str, dst: str) -> Link:
        if src == dst:
            return self.loopback
        if (src, dst) in self.links:
            return self.links[(src, dst)]
        if (dst, src) in self.links:
            return self.links[(dst, src)]
        raise KeyError(f"no link {src} <-> {dst}")


def paper_topology() -> Topology:
    """Raspberry Pi 4 edge + AWS cloud (c5.4xlarge EC2, Lambda, S3) with a
    WAN link calibrated to the paper's latency regime."""
    # Pi inference runs near-parity with the c5 for the tiny TFLite LSTM
    # (paper Table 3: edge comp 10.25 s vs cloud 8.82 s); the Pi penalty
    # shows up in *training* (OOM) and in contention (see modules.py)
    # any one of our training jobs saturates the Pi's 4 small cores (workers=1)
    # while the 16-vCPU c5.4xlarge overlaps training with inference
    sites = {
        "edge": Site("edge", "edge", compute_scale=0.85, memory_bytes=4e9,
                     workers=1),
        "cloud": Site("cloud", "cloud", compute_scale=2.0, memory_bytes=32e9,
                      workers=4),
    }
    links = {
        ("edge", "cloud"): Link(latency_s=0.045, bandwidth_Bps=2.5e6),
    }
    return Topology(sites=sites, links=links)


@dataclass
class Message:
    topic: str
    payload: Any
    nbytes: float
    src: str
    publish_time: float
    deliver_time: float = 0.0


@dataclass
class DeadLetter:
    """A publish that could not be delivered: no link between the sites, or
    a hard (drop-mode) partition in between.  Recorded instead of raising,
    so a partitioned topology is a scenario, not a crash."""

    topic: str
    src: str
    dst: str
    t: float
    reason: str


class EventKernel:
    def __init__(self) -> None:
        self._q: List[Tuple[float, int, Callable[[], None]]] = []
        self._seq = itertools.count()
        self.now = 0.0

    def at(self, t: float, fn: Callable[[], None]) -> None:
        heapq.heappush(self._q, (t, next(self._seq), fn))

    def after(self, dt: float, fn: Callable[[], None]) -> None:
        self.at(self.now + dt, fn)

    def run(self, until: Optional[float] = None) -> float:
        while self._q:
            if until is not None and self._q[0][0] > until:
                # peek, don't pop: re-pushing with a fresh sequence number
                # would silently reorder same-timestamp events across a
                # pause/resume — the chaos suite relies on exact replay
                break
            t, _, fn = heapq.heappop(self._q)
            self.now = max(self.now, t)
            fn()
        return self.now


def topic_matches(pattern: str, topic: str) -> bool:
    """MQTT single-level wildcard matching: ``+`` matches exactly one
    ``/``-separated level, at any position.  Segment counts must agree —
    ``a/+`` matches ``a/b`` but never ``a`` or ``a/b/c``."""
    ps = pattern.split("/")
    ts = topic.split("/")
    return len(ps) == len(ts) and all(
        p == "+" or p == t for p, t in zip(ps, ts))


class TopicBus:
    """MQTT-like pub/sub across sites with link-cost delivery.

    Topics are ``/``-separated names.  A subscription may end in the MQTT
    single-level wildcard ``+``: ``"stream/window/+"`` receives every
    publish one level below ``stream/window`` — how a fleet executor
    subscribes one handler to all of its per-stream topics
    (``stream/window/t00``, ``stream/window/t01``, ...) under one
    ``Deployment``.

    A publish to a site with no link from the source is not an error: it is
    dropped and recorded in ``dead_letters`` (topic/src/dst/reason), so a
    partitioned topology degrades instead of crashing.

    An optional ``fault_plane`` (the chaos plane's
    ``runtime.faults.FaultPlane``) interposes on every per-subscriber
    delivery: it can drop, delay, duplicate, reorder, corrupt or forge the
    delivery, queue it behind a WAN partition, or lose it to a crashed
    site.  With no plane attached the
    publish path is byte-identical to the pre-fault code."""

    def __init__(self, kernel: EventKernel, topo: Topology,
                 fault_plane: Optional[Any] = None):
        self.kernel = kernel
        self.topo = topo
        self.fault_plane = fault_plane
        self._subs: Dict[str, List[Tuple[str, Callable[[Message], None]]]] = {}
        # patterns with a non-leaf "+" can't be dict-looked-up; they are the
        # rare case, kept in a scan list (pattern, site, fn)
        self._wild: List[Tuple[str, str, Callable[[Message], None]]] = []
        self.log: List[Message] = []
        self.dead_letters: List[DeadLetter] = []

    @staticmethod
    def _is_scan_pattern(topic: str) -> bool:
        return "+" in topic.split("/")[:-1]

    def subscribe(self, topic: str, site: str, fn: Callable[[Message], None]):
        if self._is_scan_pattern(topic):
            self._wild.append((topic, site, fn))
        else:
            self._subs.setdefault(topic, []).append((site, fn))

    def unsubscribe(self, topic: str, site: str,
                    fn: Callable[[Message], None]) -> bool:
        """Remove one (site, fn) registration for ``topic``; returns whether
        anything was removed.  Migration republishes a stream's topics by
        unsubscribing the handler at the old site and re-subscribing it at
        the new one — in-flight deliveries already scheduled keep the
        handler they were matched to at publish time."""
        if self._is_scan_pattern(topic):
            for i, (pat, s, f) in enumerate(self._wild):
                if pat == topic and s == site and f == fn:
                    del self._wild[i]
                    return True
            return False
        subs = self._subs.get(topic, [])
        for i, (s, f) in enumerate(subs):
            if s == site and f == fn:
                del subs[i]
                return True
        return False

    def _matches(self, topic: str) -> List[Tuple[str, Callable[[Message], None]]]:
        subs = list(self._subs.get(topic, []))
        head, _, leaf = topic.rpartition("/")
        if leaf != "+":
            subs += self._subs.get((head + "/+") if head else "+", [])
        if self._wild:
            subs += [(s, f) for pat, s, f in self._wild
                     if topic_matches(pat, topic)]
        return subs

    def publish(self, topic: str, payload: Any, nbytes: float, src: str) -> None:
        msg_t = self.kernel.now
        fp = self.fault_plane
        for site, fn in self._matches(topic):
            try:
                link = self.topo.link(src, site)
            except KeyError:
                self.dead_letters.append(
                    DeadLetter(topic=topic, src=src, dst=site, t=msg_t,
                               reason="no-link"))
                continue
            dt = link.transfer_time(nbytes)
            if fp is None:
                msg = Message(topic=topic, payload=payload, nbytes=nbytes,
                              src=src, publish_time=msg_t,
                              deliver_time=msg_t + dt)
                self.log.append(msg)
                self.kernel.at(msg_t + dt, lambda fn=fn, msg=msg: fn(msg))
                continue
            for t_del, pl in fp.plan_deliveries(topic, payload, src, site,
                                                msg_t, dt, self):
                msg = Message(topic=topic, payload=pl, nbytes=nbytes, src=src,
                              publish_time=msg_t, deliver_time=t_del)
                self.log.append(msg)
                self.kernel.at(
                    t_del,
                    lambda fn=fn, msg=msg, site=site:
                        self._deliver(fn, msg, site))

    def _deliver(self, fn: Callable[[Message], None], msg: Message,
                 site: str) -> None:
        """Fault-aware delivery: a message addressed to a site that is down
        *at delivery time* is lost (the site may have crashed after the
        publish was already in flight)."""
        fp = self.fault_plane
        if fp is not None and fp.site_down(site, self.kernel.now):
            fp.note("lost_delivery_site_down", self.kernel.now,
                    f"{msg.topic}->{site}")
            return
        fn(msg)
