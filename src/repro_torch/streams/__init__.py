"""Stream sources, scaling, the data-injection throttle and the wind-farm
CSV reader (numpy), copied from the reference."""
from repro_torch.streams.injection import (  # noqa: F401
    DataInjection,
    ThrottleConfig,
    stream_windows,
)
from repro_torch.streams.normalize import MinMaxScaler  # noqa: F401
from repro_torch.streams import sources  # noqa: F401
