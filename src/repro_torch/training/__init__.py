"""Training of the port: the optimizers, the train and eval steps, the
checkpoints, the legacy per-minibatch ``fit``, and the speed layer's
trainers, the single-stream ``CompiledForecaster`` and the fleet's
``FleetForecaster``."""
from repro_torch.training.optimizer import (  # noqa: F401
    Optimizer,
    OptState,
    adamw,
    sgd,
    warmup_cosine,
)
from repro_torch.training.train_loop import (  # noqa: F401
    fit,
    make_eval_step,
    make_train_step,
)
from repro_torch.training.compiled import (  # noqa: F401
    CompiledForecaster,
    FleetForecaster,
    FleetParamView,
    bucket_examples,
    bucket_streams,
    materialize_params,
    pad_to_bucket,
)
from repro_torch.training import checkpoint  # noqa: F401
