"""Serving of the port: int8 weight quantization for the edge's model sync
(``quantize``; a fleet's in one pass, ``quantize_fleet``), request batching
(``batching``), the fleet's request plane (``query_plane``) and the model
zoo's serving engine (``engine``)."""
from repro_torch.serving.query_plane import (  # noqa: F401
    QUERY_KINDS,
    ForecastQuery,
    QueryPlane,
    answer_query_unbatched,
    latency_stats,
    open_loop_trace,
)
from repro_torch.serving.quantize import (  # noqa: F401
    QTensor,
    dequantize_tree,
    quantize_fleet,
    quantize_tree,
    tree_checksum,
    tree_nbytes,
)
