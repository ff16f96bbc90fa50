"""Training of the port: AdamW, the train step, and the speed layer's
single-stream ``CompiledForecaster``."""
from repro_torch.training.optimizer import Optimizer, OptState, adamw  # noqa: F401
from repro_torch.training.train_loop import make_train_step  # noqa: F401
from repro_torch.training.compiled import (  # noqa: F401
    CompiledForecaster,
    bucket_examples,
    pad_to_bucket,
)
