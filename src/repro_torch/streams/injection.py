"""Data-injection module (paper Sec. 3 / 5.2): a transfer station that
throttles the continuous stream into per-time-window payloads, here the
bus-side injector that publishes each window onto the stream topic.  The
reference's throttle buffer (``ThrottleConfig``, ``DataInjection``) and
``stream_windows`` come with the slice that ports the calibrated launcher
mode.
"""
from __future__ import annotations

from typing import Optional


class BusInjector:
    """Feed windowed stream payloads onto a topic bus (the data_injection
    module of the bus-scheduled pipeline): window ``w`` is published on
    ``topic`` at virtual time ``w * period_s`` from ``site``, carrying the
    window's real supervised arrays; ``nbytes`` is the actual payload size so
    link transfer times reflect the data that moves.

    With a ``stream_id``, the injector is one member of a fleet: it
    publishes on the per-stream topic ``topic/<stream_id>`` (the fleet
    executors subscribe the ``topic/+`` wildcard) and stamps the stream id
    into every payload.

    A ``fault_plane`` models the sensor itself going bad: each nominal
    window expands (via ``FaultPlane.sensor_windows``) into zero or more
    actual publishes — dropped windows, out-of-order jitter, duplicates,
    per-record dropout, Byzantine values — before the payload ever reaches
    the bus.

    A ``health_plane`` screens what the (possibly lying) sensor produced:
    its ``ByzantineGuard`` (``runtime.health``) gates every window's target
    values through per-stream rolling median/MAD plausibility checks,
    imputing flagged values before the window reaches the bus, the defense
    the Byzantine sensor fault exists to exercise, and counts each flagged
    window as a sensor fault.  Clean windows pass through untouched (same
    array objects), so a fault-free run is byte-identical with or without
    the guard."""

    def __init__(self, kernel, bus, topic: str, site: str,
                 period_s: float = 30.0, stream_id: Optional[str] = None,
                 fault_plane=None, health_plane=None):
        self.kernel = kernel
        self.bus = bus
        self.topic = topic if stream_id is None else f"{topic}/{stream_id}"
        self.site = site
        self.period_s = period_s
        self.stream_id = stream_id
        self.fault_plane = fault_plane
        self.health_plane = health_plane
        self.injected = 0

    def schedule_window(self, w: int, data: dict) -> float:
        """Schedule window ``w``'s publish; returns its *nominal* injection
        time (sensor faults may move, multiply, or remove the actual
        publishes)."""
        t = w * self.period_s
        deliveries = [(t, data)]
        sid = self.stream_id if self.stream_id is not None else ""
        if self.fault_plane is not None:
            deliveries = self.fault_plane.sensor_windows(sid, w, t, data)
        if self.health_plane is not None:
            screened = []
            for t_i, d in deliveries:
                d2, n_flagged = self.health_plane.guard.screen(sid, d, t_i)
                if n_flagged:
                    self.health_plane.observe_fault("sensor", sid, t_i)
                screened.append((t_i, d2))
            deliveries = screened
        for t_i, d in deliveries:
            payload = {"window": w, "x": d["x"], "y": d["y"]}
            if self.stream_id is not None:
                payload["stream"] = self.stream_id
            nbytes = float(d["x"].nbytes + d["y"].nbytes)
            self.kernel.at(
                t_i,
                lambda payload=payload, nbytes=nbytes: self.bus.publish(
                    self.topic, payload, nbytes, self.site))
        self.injected += 1
        return t
