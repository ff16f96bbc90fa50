"""The paper's primary contribution: adaptive hybrid stream analytics
(lambda-architecture batch/speed/hybrid layers + static/dynamic weighting)."""
from repro_torch.core.hybrid import (  # noqa: F401
    Forecaster,
    HybridRunResult,
    HybridStreamAnalytics,
    WindowRecord,
    lstm_forecaster,
    pretrain_batch_model,
)
from repro_torch.core.stages import PipelineStages  # noqa: F401
from repro_torch.core.weighting import (  # noqa: F401
    combine,
    dwa_closed_form,
    dwa_scipy,
    rmse,
    static_weights,
)
from repro_torch.core.windows import (  # noqa: F401
    WindowedStream,
    WindowPlan,
    make_supervised,
)
