"""Training of the port: AdamW, the train step, and the speed layer's
trainers, the single-stream ``CompiledForecaster`` and the fleet's
``FleetForecaster``."""
from repro_torch.training.optimizer import Optimizer, OptState, adamw  # noqa: F401
from repro_torch.training.train_loop import make_train_step  # noqa: F401
from repro_torch.training.compiled import (  # noqa: F401
    CompiledForecaster,
    FleetForecaster,
    FleetParamView,
    bucket_examples,
    bucket_streams,
    materialize_params,
    pad_to_bucket,
)
