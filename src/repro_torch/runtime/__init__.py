"""The port's runtime: the topic bus and its sites and links, the paper's
three deployments, latency accounting, the chaos plane (``FaultPlane`` and
its fault specs), the health plane (``HealthPlane``, signed model sync), the
elastic placement plane (``PlacementController`` and its
``LoadForecaster``), and the executors (the synchronous loop and the
bus-driven ``BusExecutor``, and their fleet counterparts
``InProcessFleetExecutor`` and ``FleetBusExecutor``), and the calibrated
Table-3 simulation (``EdgeCloudSimulation``)."""
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
from repro_torch.runtime.faults import (  # noqa: F401
    FaultPlane,
    MessageFault,
    PartitionFault,
    SensorFault,
    SiteFault,
    corrupt_tree,
    forge_tree,
    tree_checksum,
)
from repro_torch.runtime.health import (  # noqa: F401
    ByzantineGuard,
    FaultRateEstimator,
    HealthConfig,
    HealthPlane,
    derive_sync_key,
    sign_tree,
    verify_tree,
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
from repro_torch.runtime.modules import EdgeCloudSimulation, SimulationResult  # noqa: F401
