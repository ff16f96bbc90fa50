"""The paper's three deployment modalities (Sec. 4, Fig. 3): module -> site
placement maps.  The same module implementations run anywhere (Sec. 4.4's
"same modules and implementations reused when switching deployments")."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

MODULES = (
    "data_injection",
    "batch_inference",
    "speed_inference",
    "hybrid_inference",
    "model_sync",
    "data_sync",
    "speed_training",
    "archiving",
)

# Modules whose placement is meaningful *per stream*: the inference chain a
# fleet stream rides every window plus its model-sync install.  The elastic
# placement controller migrates exactly these; data_injection stays at the
# sensor and training/archiving stay fleet-global.
STREAM_MODULES = (
    "batch_inference",
    "speed_inference",
    "hybrid_inference",
    "model_sync",
)


@dataclass(frozen=True)
class Deployment:
    """Module -> site placement, plus an optional per-stream overlay.

    ``stream_placement`` maps a stream id to a site name; for the modules in
    :data:`STREAM_MODULES` it overrides the fleet-wide placement for that
    stream.  The dataclass stays frozen (the *identity* of a deployment never
    changes) but the overlay dict is mutable: ``pin_stream`` /
    ``unpin_stream`` are how static per-stream pins are expressed, and the
    elastic executor reads it as the *initial* placement — runtime migrations
    are tracked executor-side so one Deployment object can be reused across
    runs."""

    name: str
    placement: Dict[str, str]  # module -> site name
    stream_placement: Dict[str, str] = field(default_factory=dict)

    def site_of(self, module: str, stream: Optional[str] = None) -> str:
        if (stream is not None and module in STREAM_MODULES
                and stream in self.stream_placement):
            return self.stream_placement[stream]
        return self.placement[module]

    def pin_stream(self, stream: str, site: str) -> None:
        self.stream_placement[stream] = site

    def unpin_stream(self, stream: str) -> None:
        self.stream_placement.pop(stream, None)


def edge_centric() -> Deployment:
    """Everything on the edge (whole-cloud-unavailable scenario, Fig. 3a).
    Speed training on the Pi exceeds its capacity -> CapacityError, which is
    the paper's measured OOM result."""
    return Deployment(
        "edge-centric", {m: "edge" for m in MODULES}
    )


def cloud_centric() -> Deployment:
    """Edge only senses + forwards; all processing in the cloud (Fig. 3b)."""
    p = {m: "cloud" for m in MODULES}
    p["data_injection"] = "edge"  # sensing stays physically at the source
    return Deployment("cloud-centric", p)


def edge_cloud_integrated() -> Deployment:
    """Inference + sync on edge; speed training + archiving on cloud
    (Fig. 3c) — the paper's recommended deployment."""
    return Deployment(
        "edge-cloud-integrated",
        {
            "data_injection": "edge",
            "batch_inference": "edge",
            "speed_inference": "edge",
            "hybrid_inference": "edge",
            "model_sync": "edge",
            "data_sync": "edge",
            "speed_training": "cloud",
            "archiving": "cloud",
        },
    )


ALL_DEPLOYMENTS = {
    "edge-centric": edge_centric,
    "cloud-centric": cloud_centric,
    "edge-cloud-integrated": edge_cloud_integrated,
}
