"""The port's runtime: the topic bus and its sites and links, the paper's
three deployments, latency accounting, the elastic placement plane
(``PlacementController`` and its ``LoadForecaster``), and the executors (the
synchronous loop and the bus-driven ``BusExecutor``, and their fleet
counterparts ``InProcessFleetExecutor`` and ``FleetBusExecutor``)."""
from repro_torch.runtime.bus import (  # noqa: F401
    CapacityError,
    DeadLetter,
    EventKernel,
    Link,
    Message,
    Site,
    TopicBus,
    Topology,
    paper_topology,
    topic_matches,
)
from repro_torch.runtime.deployment import (  # noqa: F401
    ALL_DEPLOYMENTS,
    STREAM_MODULES,
    Deployment,
    cloud_centric,
    edge_centric,
    edge_cloud_integrated,
)
from repro_torch.runtime.placement import (  # noqa: F401
    LoadForecaster,
    PlacementController,
    PlacementDecision,
    SiteSignal,
    StreamSignal,
)
from repro_torch.runtime.executor import (  # noqa: F401
    BusExecutor,
    BusRunResult,
    FleetBusExecutor,
    FleetBusRunResult,
    FleetRunResult,
    InProcessExecutor,
    InProcessFleetExecutor,
    fleet_key_chains,
    refresh_key_chains,
    stream_roots,
    window_seeds,
)
from repro_torch.runtime.latency import CostModel, LatencyLedger  # noqa: F401
